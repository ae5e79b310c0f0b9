"""Phone-loop scan kernels: wrappers, plain PyTorch versions, launch counts.

Counterpart of the four ``beer_tpu/ops/pallas_scan.py`` kernels on the
phone-loop AUD main path.  Each wrapper below takes batch-major
tensors and

* on a CPU tensor runs its plain PyTorch version (same outputs),
* on a CUDA tensor checks device, dtype (float32), shape and
  contiguity, allocates its outputs with ``torch.empty``, launches the
  hand-written CUDA kernel of ``beer_tpu_torch/csrc/phone_loop_scan.cu``
  on the current stream, raises if the launch was refused, and counts
  the launch in :data:`KERNELS`.  It never falls back to the plain
  version.

The kernels are compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use, into
``beer_tpu_torch/_build/`` under a name keyed on a hash of the sources,
and loaded with ``ctypes``.  Nothing is built or imported at module
import.

The plain versions loop over time in Python and are vectorised over the
batch; tests and the on-card comparison call them directly.

Shapes (B utterances, T frames, S states, P reduced stats, U units):
``stats`` (B, T, P); ``lens`` (B,) int32 lengths of prefix masks;
``w`` (S, P) and ``bias`` (S,) with llh = stats @ wᵀ + bias;
``bands`` (4, S) = [a_self, a_adv, exit, w] such that the transition
matrix is diag(a_self) + superdiag(a_adv) + exit ⊗ w.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

NEG = -1e30
XI_FLOOR = 1e-30
SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: its wrapper's name, source and launch count."""

    name: str
    source: str
    launches: int = 0


KERNELS = {
    name: Kernel(name, "beer_tpu_torch/csrc/phone_loop_scan.cu")
    for name in ("forward_llh_banded", "estep_acc_banded",
                 "viterbi_fwd_banded", "viterbi_backtrace_banded")
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


# ----------------------------------------------------------------------
# Build and load
# ----------------------------------------------------------------------
def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): cannot build the CUDA kernels")
    return str(path)


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libbeer_scan_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these exact sources exists.

    The ``-Xptxas -v`` report (registers, shared memory, spills per
    kernel) is kept beside the library as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, out)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i, z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    signatures = {
        "beer_forward_llh_banded": [i] + [p] * 10 + [i] * 4 + [p],
        "beer_estep_acc_banded": [i] + [p] * 13 + [i] * 5 + [p],
        "beer_viterbi_fwd_banded": [i] + [p] * 7 + [i] * 3 + [p],
        "beer_viterbi_backtrace_banded": [i] + [p] * 6 + [i] * 3 + [p],
    }
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.beer_forward_smem_bytes.argtypes = [i, i]
    lib.beer_forward_smem_bytes.restype = z
    lib.beer_estep_smem_bytes.argtypes = [i, i, i]
    lib.beer_estep_smem_bytes.restype = z
    lib.beer_error_string.argtypes = [i]
    lib.beer_error_string.restype = ctypes.c_char_p
    return lib


def _check(tensors: dict, device: torch.device, dtypes: dict) -> None:
    for name, x in tensors.items():
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        want = dtypes.get(name, torch.float32)
        if x.dtype != want:
            raise TypeError(f"{name} has dtype {x.dtype}; the CUDA kernel takes {want}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _shape(name: str, x: torch.Tensor, shape: tuple) -> None:
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")


def _launch(fn, *args) -> None:
    lib = _library()
    code = fn(*args)
    if code != 0:
        raise RuntimeError(f"CUDA kernel launch failed: {lib.beer_error_string(code).decode()}")


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _max_len(lens: torch.Tensor) -> int:
    return int(lens.max()) if lens.numel() else 0


def _shift_down(x: torch.Tensor) -> torch.Tensor:
    """y[..., j] = x[..., j−1]; y[..., 0] = 0."""
    return torch.nn.functional.pad(x[..., :-1], (1, 0))


def _shift_up(x: torch.Tensor) -> torch.Tensor:
    """y[..., j] = x[..., j+1]; y[..., −1] = 0."""
    return torch.nn.functional.pad(x[..., 1:], (0, 1))


# ----------------------------------------------------------------------
# K1: scaled banded forward with in-kernel ELLH
# ----------------------------------------------------------------------
def forward_llh_banded_plain(stats, lens, w, bias, bands, init):
    """Plain version of :func:`forward_llh_banded` (any dtype and device)."""
    b, t_len, _ = stats.shape
    s = w.shape[0]
    tiny = torch.finfo(stats.dtype).tiny
    a_self, a_adv, exit_v, w_v = bands
    lens = lens.to(stats.device)
    llh = torch.matmul(stats, w.T) + bias
    alpha = stats.new_zeros(b, t_len, s)
    norms = stats.new_ones(b, t_len)
    logz = stats.new_zeros(b)
    p = init.expand(b, s).clone()
    for t in range(_max_len(lens)):
        valid = (t < lens)[:, None]
        llh_t = llh[:, t]
        mx = llh_t.max(-1, keepdim=True).values
        e = torch.exp(llh_t - mx)
        if t == 0:
            base = p
        else:
            q = (p * exit_v).sum(-1, keepdim=True)
            base = p * a_self + _shift_down(p * a_adv) + q * w_v
        raw = base * e
        norm = raw.sum(-1, keepdim=True).clamp_min(tiny)
        p_new = raw / norm
        p = torch.where(valid, p_new, p)
        alpha[:, t] = torch.where(valid, p_new, 0.0)
        norms[:, t] = torch.where(valid, norm, 1.0)[:, 0]
        logz = torch.where(valid[:, 0], logz + (torch.log(norm) + mx)[:, 0], logz)
    return alpha, norms, p, logz


def forward_llh_banded(stats, lens, w, bias, bands, init):
    """Scaled forward through band + rank-1 phone-loop transitions, with
    llh = W·stats + bias computed in the kernel (llh never stored).

    Returns ``alpha`` (B, T, S) per-frame normalised α̂ (0 on frames
    t >= len), ``norms`` (B, T) per-step normalisers (1 there), ``last``
    (B, S) = α̂ at the last frame (``init`` for empty rows) and
    ``logz_base`` (B,) = Σ_t log norm_t + max_s llh_t (0 for empty rows);
    log Z = logz_base + log Σ last·final.
    """
    if stats.device.type == "cpu":
        return forward_llh_banded_plain(stats, lens, w, bias, bands, init)
    b, t_len, p_dim = stats.shape
    s = w.shape[0]
    dev = stats.device
    _check(dict(stats=stats, lens=lens, w=w, bias=bias, bands=bands, init=init), dev,
           dict(lens=torch.int32))
    for name, x, shape in (("lens", lens, (b,)), ("w", w, (s, p_dim)), ("bias", bias, (s,)),
                           ("bands", bands, (4, s)), ("init", init, (s,))):
        _shape(name, x, shape)
    lib = _library()
    smem = lib.beer_forward_smem_bytes(s, p_dim)
    if smem > SMEM_LIMIT:
        raise ValueError(f"S={s}, P={p_dim} needs {smem} B of shared memory (> {SMEM_LIMIT})")
    alpha = torch.empty(b, t_len, s, device=dev)
    norms = torch.empty(b, t_len, device=dev)
    last = torch.empty(b, s, device=dev)
    logz = torch.empty(b, device=dev)
    _launch(lib.beer_forward_llh_banded, dev.index, *map(_ptr, (
        stats, lens, w, bias, bands, init, alpha, norms, last, logz)),
        b, t_len, s, p_dim, _stream(dev))
    KERNELS["forward_llh_banded"].launches += 1
    return alpha, norms, last, logz


# ----------------------------------------------------------------------
# K2: accumulating v-space backward (γ moments, γ0, loop-back ξ)
# ----------------------------------------------------------------------
def estep_acc_banded_plain(stats, lens, w, bias, bands, final, alpha, norms, ends, starts):
    """Plain version of :func:`estep_acc_banded` (any dtype and device)."""
    b, t_len, p_dim = stats.shape
    s = w.shape[0]
    n_u = ends.shape[0]
    dt = stats.dtype
    tiny = torch.finfo(dt).tiny
    a_self, a_adv, exit_v, w_v = bands
    lens = lens.to(stats.device)
    ends, starts = ends.long(), starts.long()
    llh = torch.matmul(stats, w.T) + bias
    acc = stats.new_zeros(s, p_dim + 1)
    gamma0 = stats.new_zeros(b, s)
    xi = stats.new_zeros(n_u, n_u)
    v_hat = stats.new_zeros(b, s)
    wgt_next = stats.new_zeros(b, 1)
    ones = stats.new_ones(b, 1)
    for t in range(_max_len(lens) - 1, -1, -1):
        valid = (t < lens)[:, None]
        is_last = (t == lens - 1)[:, None]
        llh_t = llh[:, t]
        e = torch.exp(llh_t - llh_t.max(-1, keepdim=True).values)
        r = (v_hat * w_v).sum(-1, keepdim=True)
        u1 = v_hat * a_self + _shift_up(v_hat) * a_adv + r * exit_v
        u1 = torch.where(is_last, final, u1)
        v = e * u1
        ab = alpha[:, t] * u1
        sv = v.sum(-1, keepdim=True).clamp_min(tiny)
        absum = ab.sum(-1, keepdim=True)
        gamma = torch.where(valid, ab / absum.clamp_min(tiny), 0.0)
        denom = norms[:, t, None] * absum / sv
        wgt = torch.where(valid & (denom > XI_FLOOR), 1.0 / denom.clamp_min(XI_FLOOR), 0.0)
        acc += gamma.T @ torch.cat([stats[:, t], ones], dim=-1)
        pair = valid & ~is_last
        xi += (torch.where(pair, alpha[:, t, ends] * wgt_next, 0.0)).T @ v_hat[:, starts]
        v_hat = torch.where(valid, v / sv, v_hat)
        wgt_next = wgt
        if t == 0:
            gamma0 = gamma
    return acc[:, :p_dim], acc[:, p_dim], gamma0, xi


def estep_acc_banded(stats, lens, w, bias, bands, final, alpha, norms, ends, starts):
    """Backward smoothing pass that reduces γ in the kernel.

    Takes the forward's stored ``alpha`` (B, T, S) and ``norms`` (B, T),
    ``final`` (S,) and the unit ``ends``/``starts`` (U,) int32 state
    indices.  Returns ``acc2`` (S, P) = Σ_{b,t} γ ⊗ stats, ``counts``
    (S,) = Σ γ, ``gamma0`` (B, S) = γ at the first frame, and ``xi_raw``
    (U, U) = Σ_t (α̂_t[ends]·wgt_{t+1}) ⊗ ŵ_{t+1}[starts]; the expected
    loop-arc counts are ``xi_raw`` times the loop-block transition
    probabilities.  γ itself is never stored.
    """
    if stats.device.type == "cpu":
        return estep_acc_banded_plain(stats, lens, w, bias, bands, final, alpha, norms,
                                      ends, starts)
    b, t_len, p_dim = stats.shape
    s = w.shape[0]
    n_u = ends.shape[0]
    dev = stats.device
    _check(dict(stats=stats, lens=lens, w=w, bias=bias, bands=bands, final=final,
                alpha=alpha, norms=norms, ends=ends, starts=starts), dev,
           dict(lens=torch.int32, ends=torch.int32, starts=torch.int32))
    for name, x, shape in (("lens", lens, (b,)), ("w", w, (s, p_dim)), ("bias", bias, (s,)),
                           ("bands", bands, (4, s)), ("final", final, (s,)),
                           ("alpha", alpha, (b, t_len, s)), ("norms", norms, (b, t_len)),
                           ("ends", ends, (n_u,)), ("starts", starts, (n_u,))):
        _shape(name, x, shape)
    lib = _library()
    smem = lib.beer_estep_smem_bytes(s, p_dim, n_u)
    if smem > SMEM_LIMIT:
        raise ValueError(f"S={s}, P={p_dim}, U={n_u} needs {smem} B of shared memory "
                         f"(> {SMEM_LIMIT})")
    width = s * (p_dim + 1) + n_u * n_u
    part = torch.empty(b, width, device=dev)
    out = torch.empty(width, device=dev)
    gamma0 = torch.empty(b, s, device=dev)
    _launch(lib.beer_estep_acc_banded, dev.index, *map(_ptr, (
        stats, lens, w, bias, bands, final, alpha, norms, ends, starts, part, out, gamma0)),
        b, t_len, s, p_dim, n_u, _stream(dev))
    KERNELS["estep_acc_banded"].launches += 1
    acc = out[: s * (p_dim + 1)].view(s, p_dim + 1)
    return acc[:, :p_dim], acc[:, p_dim], gamma0, out[s * (p_dim + 1):].view(n_u, n_u)


# ----------------------------------------------------------------------
# K3: banded (max,+) Viterbi forward
# ----------------------------------------------------------------------
def viterbi_fwd_banded_plain(llh, lens, log_bands, log_init):
    """Plain version of :func:`viterbi_fwd_banded` (any dtype and device)."""
    b, t_len, s = llh.shape
    ls, la, le, lw = log_bands
    lens = lens.to(llh.device)
    choices = torch.zeros(b, t_len, s, dtype=torch.int8, device=llh.device)
    exarg = torch.zeros(b, t_len, dtype=torch.int32, device=llh.device)
    if t_len == 0:
        return choices, exarg, log_init.expand(b, s).clone()
    a = torch.clamp(log_init + llh[:, 0], min=NEG)
    neg = llh.new_full((b, 1), NEG)
    for t in range(1, _max_len(lens)):
        valid = t < lens
        c_self = a + ls
        c_adv = torch.cat([neg, (a + la)[:, :-1]], dim=1)
        exb, exi = (a + le).max(-1, keepdim=True)
        c_loop = exb + lw
        best = torch.maximum(c_self, torch.maximum(c_adv, c_loop))
        choice = torch.where(c_self >= best, 0, torch.where(c_adv >= best, 1, 2))
        new = torch.clamp(llh[:, t] + best, min=NEG)
        a = torch.where(valid[:, None], new, a)
        choices[:, t] = torch.where(valid[:, None], choice, 0).to(torch.int8)
        exarg[:, t] = torch.where(valid, exi[:, 0], 0).to(torch.int32)
    return choices, exarg, a


def viterbi_fwd_banded(llh, lens, log_bands, log_init):
    """(max,+) forward through the band + rank-1 factorisation.

    ``llh`` (B, T, S) state log-likelihoods, ``log_bands`` (4, S) the
    log of ``bands`` (−1e30 where a band is 0), ``log_init`` (S,).
    Returns ``choices`` (B, T, S) int8 in {0 stay, 1 advance, 2 loop}
    (0 on frame 0 and on frames t >= len), ``exarg`` (B, T) int32 exit
    arg-max per step (smallest index on ties) and ``alpha_last`` (B, S).
    """
    if llh.device.type == "cpu":
        return viterbi_fwd_banded_plain(llh, lens, log_bands, log_init)
    b, t_len, s = llh.shape
    dev = llh.device
    _check(dict(llh=llh, lens=lens, log_bands=log_bands, log_init=log_init), dev,
           dict(lens=torch.int32))
    for name, x, shape in (("lens", lens, (b,)), ("log_bands", log_bands, (4, s)),
                           ("log_init", log_init, (s,))):
        _shape(name, x, shape)
    choices = torch.empty(b, t_len, s, dtype=torch.int8, device=dev)
    exarg = torch.empty(b, t_len, dtype=torch.int32, device=dev)
    alpha_last = torch.empty(b, s, device=dev)
    _launch(_library().beer_viterbi_fwd_banded, dev.index, *map(_ptr, (
        llh, lens, log_bands, log_init, choices, exarg, alpha_last)),
        b, t_len, s, _stream(dev))
    KERNELS["viterbi_fwd_banded"].launches += 1
    return choices, exarg, alpha_last


# ----------------------------------------------------------------------
# K4: Viterbi backtrace
# ----------------------------------------------------------------------
def viterbi_backtrace_banded_plain(choices, exarg, alpha_last, log_final):
    """Plain version of :func:`viterbi_backtrace_banded` (any device)."""
    b, t_len, _ = choices.shape
    scores, state = (alpha_last + log_final).max(-1)
    paths = torch.zeros(b, t_len, dtype=torch.int32, device=choices.device)
    if t_len == 0:
        return paths, scores
    paths[:, -1] = state
    for t in range(t_len - 1, 0, -1):
        c = choices[:, t].gather(1, state[:, None])[:, 0]
        state = torch.where(c == 0, state, torch.where(c == 1, state - 1, exarg[:, t].long()))
        state = state.clamp_min(0)
        paths[:, t - 1] = state
    return paths, scores


def viterbi_backtrace_banded(choices, exarg, alpha_last, log_final):
    """Best paths from :func:`viterbi_fwd_banded`'s outputs.

    Returns ``paths`` (B, T) int32 state ids (frames past an utterance's
    end repeat its last state) and ``scores`` (B,) = max_s α_last +
    log_final, whose arg-max (first on ties) ends the path.
    """
    if choices.device.type == "cpu":
        return viterbi_backtrace_banded_plain(choices, exarg, alpha_last, log_final)
    b, t_len, s = choices.shape
    dev = choices.device
    _check(dict(choices=choices, exarg=exarg, alpha_last=alpha_last, log_final=log_final), dev,
           dict(choices=torch.int8, exarg=torch.int32))
    for name, x, shape in (("exarg", exarg, (b, t_len)), ("alpha_last", alpha_last, (b, s)),
                           ("log_final", log_final, (s,))):
        _shape(name, x, shape)
    paths = torch.empty(b, t_len, dtype=torch.int32, device=dev)
    scores = torch.empty(b, device=dev)
    _launch(_library().beer_viterbi_backtrace_banded, dev.index, *map(_ptr, (
        choices, exarg, alpha_last, log_final, paths, scores)),
        b, t_len, s, _stream(dev))
    KERNELS["viterbi_backtrace_banded"].launches += 1
    return paths, scores
