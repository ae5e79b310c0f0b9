"""Helpers for the tests that hold beer_tpu_torch against beer_tpu.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs on the CPU (x64 enabled by conftest), the port on the CPU
through the plain PyTorch versions of its kernels.  The JAX-side weight
extractor lives here, not in the port, because it needs jax.
"""

from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(1)  # the suite runs several xdist workers

# small port shapes: U units × SPU states, D dims, B utterances, T frames
U, SPU, D, B, T = 4, 3, 3, 4, 20


def lengths_and_mask(t_len: int = T):
    """One full row, two ragged rows, one zero-length row."""
    lengths = np.array([t_len, t_len - 7, 5, 0])
    mask = (np.arange(t_len)[None] < lengths[:, None]).astype(np.float64)
    return lengths, mask


def scan_problem(seed: int, n_units: int, spu: int, p_dim: int, b: int, t_len: int,
                 lengths=None) -> dict:
    """Seeded numpy inputs of one phone-loop E-step and decode: reduced
    stats, ELLH matrix and bias, bands (4, S), init/final vectors, unit
    ends/starts, lengths and the prefix mask (default lengths: one full,
    two ragged, one zero-length row, then random)."""
    rng = np.random.default_rng(seed)
    s = n_units * spu
    ids = np.arange(s)
    ends, starts = ids[ids % spu == spu - 1], ids[ids % spu == 0]
    a_self = np.full(s, 0.6)
    a_adv = np.where(ids % spu != spu - 1, 0.4, 0.0)
    exit_v = np.where(ids % spu == spu - 1, 0.2, 0.0)
    w_v = np.zeros(s)
    w_v[starts] = rng.dirichlet(np.ones(n_units))
    if lengths is None:
        fixed = [t_len, t_len - 7, 5, 0][:b]
        lengths = np.concatenate([fixed, rng.integers(1, t_len + 1, size=b - len(fixed))])
    lengths = np.asarray(lengths)
    mask = (np.arange(t_len)[None] < lengths[:, None]).astype(np.float64)
    return dict(stats=rng.normal(size=(b, t_len, p_dim)), w=rng.normal(size=(s, p_dim)) * 0.7,
                bias=rng.normal(size=s) - 3.0, bands=np.stack([a_self, a_adv, exit_v, w_v]),
                init=w_v.copy(), final=exit_v.copy(), lengths=lengths, mask=mask,
                ends=ends, starts=starts)


def port_args(pb: dict, dtype, device=None) -> dict:
    """:func:`scan_problem`'s arrays as the port's kernel operands."""
    f = lambda k: t(pb[k], dtype).to(device)  # noqa: E731
    i32 = lambda k: t(pb[k], torch.int32).to(device)  # noqa: E731
    return dict(stats=f("stats"), lens=i32("lengths"), w=f("w"), bias=f("bias"),
                bands=f("bands"), init=f("init"), final=f("final"), ends=i32("ends"),
                starts=i32("starts"))


def phone_loop_to_numpy(loop) -> dict:
    """A ``beer_tpu`` PhoneLoop's weights and statics in the dict layout of
    :func:`beer_tpu_torch.convert.phone_loop_from_numpy`."""
    ms = loop.modelset
    return {
        "modelset_prior": np.asarray(ms.means_precisions.prior),
        "modelset_posterior": np.asarray(ms.means_precisions.posterior),
        "sticks_prior": np.asarray(loop.unit_prior.sticks.prior),
        "sticks_posterior": np.asarray(loop.unit_prior.sticks.posterior),
        "base_log_trans": np.asarray(loop.base_log_trans),
        "log_exit": None if loop.log_exit is None else np.asarray(loop.log_exit),
        "n_units": loop.n_units,
        "states_per_unit": loop.states_per_unit,
        "self_loop": loop.self_loop,
        "dim": ms.dim,
        "cov_type": ms.cov_type,
    }


def jax_phone_loop(dtype, n_units=U, spu=SPU, dim=D, self_loop=0.5, seed=1):
    """A config-4-style JAX PhoneLoop (diagonal NormalSet, stick-breaking prior)."""
    import jax
    import jax.numpy as jnp

    import beer_tpu
    from beer_tpu.models.phoneloop import PhoneLoop

    nset = beer_tpu.NormalSet.create(
        jnp.zeros(dim, dtype), jnp.ones(dim, dtype), size=n_units * spu,
        cov_type="diagonal", noise_std=0.5, key=jax.random.PRNGKey(seed),
    )
    return PhoneLoop.create(n_units, spu, nset, self_loop=self_loop, dtype=dtype)


def to_port(jax_loop, dtype):
    from beer_tpu_torch.convert import phone_loop_from_numpy

    return phone_loop_from_numpy(phone_loop_to_numpy(jax_loop), dtype=dtype)


def t(x, dtype=None) -> torch.Tensor:
    out = torch.as_tensor(np.array(x))
    return out if dtype is None else out.to(dtype)


def close(actual, expected, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(actual, np.float64),
                               np.asarray(expected, np.float64), rtol=rtol, atol=atol)
