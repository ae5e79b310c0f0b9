"""Speech feature frontend: fbank / MFCC (PyTorch).

Counterpart of ``beer_tpu/features.py`` (pre-emphasis, framing,
windowing, FFT power spectrum, mel filter bank, log, DCT, deltas; the
recipes' ``conf/features.yml`` schema).

:func:`extract` runs on the device of its input: framing is
``Tensor.unfold``, the spectrum one ``torch.fft.rfft``, the mel
projection a float32 matmul (TF32 off, as the package sets it on
import).  The filter bank, DCT and window matrices are built in numpy
exactly as the JAX package builds them, so both packages use the same
constants.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch


# ----------------------------------------------------------------------
# Static constructors (host side, numpy: the JAX package's constants)
# ----------------------------------------------------------------------
def hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz) / 700.0)


def mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel) / 2595.0) - 1.0)


def mel_filterbank(
    n_filters: int,
    n_fft: int,
    srate: float,
    low_freq: float = 20.0,
    high_freq: Optional[float] = None,
) -> np.ndarray:
    """Triangular mel filter bank, (n_fft//2 + 1, n_filters)."""
    high_freq = high_freq or srate / 2.0
    mels = np.linspace(hz_to_mel(low_freq), hz_to_mel(high_freq), n_filters + 2)
    hz = mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * hz / srate).astype(int)
    fbank = np.zeros((n_fft // 2 + 1, n_filters))
    for j in range(n_filters):
        left, center, right = bins[j], bins[j + 1], bins[j + 2]
        for i in range(left, center):
            if center > left:
                fbank[i, j] = (i - left) / (center - left)
        for i in range(center, right):
            if right > center:
                fbank[i, j] = (right - i) / (right - center)
    return fbank


def dct_matrix(n_ceps: int, n_filters: int) -> np.ndarray:
    """Orthonormal DCT-II matrix, (n_filters, n_ceps)."""
    m = np.cos(
        math.pi / n_filters
        * (np.arange(n_filters)[:, None] + 0.5)
        * np.arange(n_ceps)[None, :]
    )
    m *= np.sqrt(2.0 / n_filters)
    m[:, 0] /= math.sqrt(2.0)
    return m


def _window(kind: str, n: int) -> np.ndarray:
    t = np.arange(n)
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(2 * math.pi * t / (n - 1))
    if kind == "hanning":
        return 0.5 - 0.5 * np.cos(2 * math.pi * t / (n - 1))
    if kind == "rectangular":
        return np.ones(n)
    raise ValueError(f"unknown window: {kind}")


def delta_kernel(order: int = 2) -> np.ndarray:
    """Regression-based delta filter (Kaldi/HTK style), length 2·order+1."""
    t = np.arange(-order, order + 1, dtype=np.float64)
    return t / (t**2).sum()


# ----------------------------------------------------------------------
# Config
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Mirrors the reference recipes' ``conf/features.yml`` schema."""

    srate: int = 16000
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    preemph: float = 0.97
    window: str = "hamming"
    n_fft: int = 512
    n_filters: int = 26
    n_ceps: int = 13
    feature_type: str = "mfcc"  # "mfcc" | "fbank"
    deltas: bool = True
    mean_norm: bool = True
    energy_floor: float = 1e-10

    @property
    def frame_length(self) -> int:
        return int(self.srate * self.frame_length_ms / 1000.0)

    @property
    def frame_shift(self) -> int:
        return int(self.srate * self.frame_shift_ms / 1000.0)

    @classmethod
    def from_dict(cls, d: dict) -> "FeatureConfig":
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


# ----------------------------------------------------------------------
# Pipeline
# ----------------------------------------------------------------------
def frame_signal(signal: torch.Tensor, frame_length: int, frame_shift: int) -> torch.Tensor:
    """(..., N) → (..., T, frame_length), a strided view; T = 1 + (N−L)//S
    (0 when N < L)."""
    n = signal.shape[-1]
    if n < frame_length:
        return signal.new_zeros(*signal.shape[:-1], 0, frame_length)
    return signal.unfold(-1, frame_length, frame_shift)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def extract(signal, conf: FeatureConfig) -> torch.Tensor:
    """Waveform (N,) → features (T, D), float32, on the device of
    ``signal`` (a tensor; a numpy array stays on the CPU)."""
    x = torch.as_tensor(signal).to(torch.float32)
    # pre-emphasis from sample 0
    x = torch.cat([x[:1], x[1:] - conf.preemph * x[:-1]])
    frames = frame_signal(x, conf.frame_length, conf.frame_shift)
    frames = frames * _const(_window(conf.window, conf.frame_length), x)
    spec = torch.fft.rfft(frames, n=conf.n_fft, dim=-1).abs() ** 2
    fbank_mat = _const(mel_filterbank(conf.n_filters, conf.n_fft, conf.srate), x)
    logmel = torch.log(torch.clamp_min(spec @ fbank_mat, conf.energy_floor))
    if conf.feature_type == "fbank":
        feats = logmel
    elif conf.feature_type == "mfcc":
        feats = logmel @ _const(dct_matrix(conf.n_ceps, conf.n_filters), x)
    else:
        raise ValueError(f"unknown feature_type: {conf.feature_type}")
    if conf.deltas:
        feats = add_deltas(feats)
    if conf.mean_norm:
        feats = feats - feats.mean(0, keepdim=True)
    return feats


def add_deltas(feats: torch.Tensor, order: int = 2) -> torch.Tensor:
    """Append Δ and Δ² computed with the regression filter; (T, 3D)."""
    kernel = _const(delta_kernel(order), feats)

    def smooth(f):
        padded = torch.cat([f[:1].expand(order, -1), f, f[-1:].expand(order, -1)])
        # (T, D, 2·order+1) windows · kernel: np.convolve(col, kernel[::-1], "valid")
        return padded.unfold(0, 2 * order + 1, 1) @ kernel

    d1 = smooth(feats)
    d2 = smooth(d1)
    return torch.cat([feats, d1, d2], dim=-1)


def add_deltas_np(feats: np.ndarray, order: int = 2) -> np.ndarray:
    """Host-side (numpy) twin of :func:`add_deltas`, the JAX package's
    ``add_deltas_np`` as it is: ``features extract`` computes deltas with
    it on each utterance's true frames, as ``beer_tpu``'s verb does."""
    kernel = delta_kernel(order).astype(feats.dtype)

    def smooth(f):
        padded = np.pad(f, ((order, order), (0, 0)), mode="edge")
        out = np.empty_like(f)
        for j in range(f.shape[1]):
            out[:, j] = np.convolve(padded[:, j], kernel[::-1], mode="valid")
        return out

    d1 = smooth(feats)
    d2 = smooth(d1)
    return np.concatenate([feats, d1, d2], axis=-1)


def fbank(signal, conf: Optional[FeatureConfig] = None, **kw) -> torch.Tensor:
    """Reference-named helper: log-mel filter bank features."""
    conf = conf or FeatureConfig(feature_type="fbank", **kw)
    if conf.feature_type != "fbank":
        conf = dataclasses.replace(conf, feature_type="fbank")
    return extract(signal, conf)


def mfcc(signal, conf: Optional[FeatureConfig] = None, **kw) -> torch.Tensor:
    """Reference-named helper: MFCC features."""
    conf = conf or FeatureConfig(feature_type="mfcc", **kw)
    if conf.feature_type != "mfcc":
        conf = dataclasses.replace(conf, feature_type="mfcc")
    return extract(signal, conf)
