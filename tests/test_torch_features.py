"""The port's feature frontend against beer_tpu's and a numpy oracle.

The cases of ``tests/test_features.py`` (filter bank coverage, DCT
orthogonality, framing, the numpy fbank oracle, MFCC shapes and
mean-norm, deltas of a constant, degraded waveforms, the config), then
the JAX package's ``features.extract`` on the same signals.

Tolerances (float32 on both sides; only the FFT's rounding differs, as
the filter bank, DCT, window and delta constants are the JAX package's
own numpy arrays, checked equal):
* log-mel within 1e-3 absolute of the numpy oracle (as the JAX tests
  hold the JAX frontend) and within 1e-4 of the JAX frontend wherever
  the mel energy is above 1e-6 (10⁴ × the default energy floor, where
  FFT rounding is far below 1e-4 relative); below it both are finite and
  the energies agree within 1e-9 absolute;
* features with deltas and mean-norm within 1e-3 of the JAX frontend;
* deltas of the same log-mel: the port's torch ``add_deltas``, its
  numpy ``add_deltas_np`` and the JAX package's ``add_deltas`` within
  1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beer_tpu import features as jax_features
from beer_tpu_torch import features


def _oracle_fbank(sig, conf):
    """Independent numpy fbank (the oracle of tests/test_features.py)."""
    x = np.concatenate([sig[:1], sig[1:] - 0.97 * sig[:-1]])
    fl, fs = conf.frame_length, conf.frame_shift
    nfr = 1 + (len(x) - fl) // fs
    frames = np.stack([x[i * fs: i * fs + fl] for i in range(nfr)])
    win = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(fl) / (fl - 1))
    spec = np.abs(np.fft.rfft(frames * win, n=512, axis=-1)) ** 2
    mel = features.mel_filterbank(26, 512, 16000)
    return np.log(np.maximum(spec @ mel, 1e-10))


def _degraded(rng):
    base = rng.normal(size=8000).astype(np.float32)
    return {
        "clipped": np.clip(3.0 * base, -1.0, 1.0).astype(np.float32),
        "dc_offset": (base + 0.5).astype(np.float32),
        "quiet": (1e-5 * base).astype(np.float32),
        "silence": np.zeros(8000, np.float32),
    }


RAW = features.FeatureConfig(feature_type="fbank", deltas=False, mean_norm=False)


def test_constants_are_the_jax_packages():
    np.testing.assert_array_equal(features.mel_filterbank(26, 512, 16000),
                                  jax_features.mel_filterbank(26, 512, 16000))
    np.testing.assert_array_equal(features.dct_matrix(13, 26), jax_features.dct_matrix(13, 26))
    np.testing.assert_array_equal(features.delta_kernel(2), jax_features.delta_kernel(2))
    for kind in ("hamming", "hanning", "rectangular"):
        np.testing.assert_array_equal(features._window(kind, 400),
                                      jax_features._window(kind, 400))
    fb = features.mel_filterbank(26, 512, 16000)
    assert fb.shape == (257, 26) and (fb >= 0).all() and (fb.sum(0) > 0).all()
    m = features.dct_matrix(13, 26)
    np.testing.assert_allclose(m.T @ m, np.eye(13), atol=1e-10)


def test_framing():
    frames = features.frame_signal(torch.arange(100.0), 25, 10)
    assert frames.shape == (8, 25)
    np.testing.assert_allclose(frames[1][:3].numpy(), [10.0, 11.0, 12.0])
    assert features.frame_signal(torch.arange(20.0), 25, 10).shape == (0, 25)


def test_numpy_oracle_fbank(rng):
    sig = rng.normal(size=8000).astype(np.float32)
    ours = features.fbank(torch.from_numpy(sig), RAW).numpy()
    oracle = _oracle_fbank(sig, RAW)
    assert ours.shape == oracle.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, oracle, rtol=1e-4, atol=1e-4)


def test_mfcc_shape_and_mean_norm(rng):
    sig = torch.from_numpy(rng.normal(size=16000).astype(np.float32))
    out = features.extract(sig, features.FeatureConfig())
    assert out.shape == (98, 13 * 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.mean(0).numpy(), 0.0, atol=1e-4)
    assert features.mfcc(sig).shape == out.shape


def test_deltas_of_constant_are_zero():
    out = features.add_deltas(torch.ones(40, 5))
    assert out.shape == (40, 15)
    np.testing.assert_allclose(out[:, 5:].numpy(), 0.0, atol=1e-7)


@pytest.mark.parametrize("case", ["clipped", "dc_offset", "quiet", "silence"])
def test_fbank_of_degraded_waveforms(rng, case):
    """Finite, on the numpy oracle and on the JAX frontend for hard
    waveforms; full extraction (deltas, mean-norm) survives them."""
    sig = _degraded(rng)[case]
    ours = features.fbank(torch.from_numpy(sig), RAW).numpy()
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, _oracle_fbank(sig, RAW), rtol=1e-3, atol=1e-3)
    theirs = np.asarray(jax_features.fbank(jnp.asarray(sig), jax_features.FeatureConfig(
        feature_type="fbank", deltas=False, mean_norm=False)))
    above = np.exp(theirs) > 1e-6
    np.testing.assert_allclose(ours[above], theirs[above], rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.exp(ours[~above]), np.exp(theirs[~above]), rtol=0, atol=1e-9)
    full = features.extract(torch.from_numpy(sig), features.FeatureConfig(feature_type="fbank"))
    assert torch.isfinite(full).all()


def test_config_from_yaml_dict():
    conf = features.FeatureConfig.from_dict(
        {"srate": 8000, "n_filters": 20, "feature_type": "fbank", "junk": 1})
    assert conf.srate == 8000 and conf.n_filters == 20
    assert conf.frame_length == 200 and conf.frame_shift == 80


@pytest.mark.parametrize("feature_type", ["fbank", "mfcc"])
def test_extract_matches_jax(rng, feature_type):
    """The recipe's pipeline (deltas and mean-norm in-graph)."""
    sig = (0.3 * rng.normal(size=12345)).astype(np.float32)
    conf = features.FeatureConfig(feature_type=feature_type)
    jconf = jax_features.FeatureConfig(**dataclasses.asdict(conf))
    ours = features.extract(torch.from_numpy(sig), conf).numpy()
    theirs = np.asarray(jax_features.extract(jnp.asarray(sig), jconf))
    assert ours.shape == theirs.shape == (1 + (12345 - 400) // 160, 39 if feature_type == "mfcc"
                                          else 78)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-3)


def test_deltas_three_ways(rng):
    feats = rng.normal(size=(37, 6)).astype(np.float32)
    ours = features.add_deltas(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(ours, features.add_deltas_np(feats), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours, np.asarray(jax_features.add_deltas(jnp.asarray(feats))),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(features.add_deltas_np(feats),
                                  jax_features.add_deltas_np(feats))
