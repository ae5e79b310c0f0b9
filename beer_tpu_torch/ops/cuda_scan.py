"""Scan kernels: wrappers, plain PyTorch versions, launch counts; the build.

Counterpart of the ``beer_tpu/ops/pallas_scan.py`` kernels on the ported
paths: the four of the phone-loop AUD main path (K1–K4, banded
transitions, ``csrc/phone_loop_scan.cu``; K2 is the banded mode of the
chunked backward in ``csrc/acc_chunks.cuh``, K1 and K3 its forward twins
on that file's helpers) and their γ-emitting backward K11 (the
structured VAE's gradient; that kernel's γ-emitting mode), the three of the Bayesian
HMM's E-step over a dense (S, S) transition matrix (K5–K7,
``csrc/hmm_scan.cu``; K6's and K7's warp instance is the dense mode of
``acc_chunks.cuh``, K7's its γ-emitting mode) with their two further modes (K14: K5 writing the
row-max shifts; K15: K7 with ξ restricted to a block), and the two of
the general probability-space path behind ``PhoneLoop.smooth`` (K12
``scaled_pass``, K13 ``smoothing_pass``, ``csrc/general_scan.cu``).  The build, the library and the launch counts in
:data:`KERNELS` also serve the full-covariance statistics kernels K8–K10
(``csrc/stats_full.cu``), wrapped in :mod:`beer_tpu_torch.ops.stats_kernels`.
Each wrapper below takes batch-major tensors and

* refuses (``RuntimeError``) an input that requires grad while grad
  mode is on, on every device: its outputs carry no gradient, so
  autograd would silently drop that input's gradient.  The
  differentiable routes reach the kernels only through the
  ``torch.autograd.Function`` classes of :mod:`beer_tpu_torch.ops.semiring_scan`
  (``PhoneLoopLogZ``, ``HMMLogZ``) and
  :class:`beer_tpu_torch.ops.stats_kernels.EllhFull`, whose forward runs
  with grad mode off;
* on a CPU tensor runs its plain PyTorch version (same outputs),
* on a CUDA tensor checks device, dtype (float32), shape and
  contiguity, allocates its outputs with ``torch.empty``, launches the
  hand-written CUDA kernel on the current stream, raises if the launch
  was refused (or the operands do not fit in shared memory), and counts
  the launch in :data:`KERNELS`.  It never falls back to the plain
  version;
* runs, on every device, inside the span ``beer.kernel.<key>``
  (:mod:`beer_tpu_torch.utils.profiling`), ``<key>`` the kernel's name
  in :data:`KERNELS`: from the operand checks to the launch on a CUDA
  tensor, the plain version on a CPU tensor.

The kernels are compiled with ``nvcc`` for ``sm_90a`` (one process per
source file, all started together, then one link) into a shared library
with a plain C interface at first use, into ``beer_tpu_torch/_build/``
under a name keyed on a hash of the sources, and loaded with ``ctypes``.
Nothing is built or imported at module import.

The plain versions loop over time in Python and are vectorised over the
batch; tests and the on-card comparison call them directly.

Shapes (B utterances, T frames, S states, P reduced stats, U units):
``stats`` (B, T, P); ``lens`` (B,) int32 lengths of prefix masks;
``w`` (S, P) and ``bias`` (S,) with llh = stats @ wᵀ + bias;
``bands`` (4, S) = [a_self, a_adv, exit, w] such that the transition
matrix is diag(a_self) + superdiag(a_adv) + exit ⊗ w; ``trans`` (S, S)
a dense transition matrix, [i, j] = p(j | i); ``init``/``final`` (B, S)
per-utterance vectors for the dense kernels.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from beer_tpu_torch.utils.profiling import scoped

NEG = -1e30
XI_FLOOR = 1e-30
SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: its wrapper's name, source and launch count."""

    name: str
    source: str
    launches: int = 0


KERNELS = {
    **{name: Kernel(name, "beer_tpu_torch/csrc/phone_loop_scan.cu")
       for name in ("forward_llh_banded", "estep_acc_banded",
                    "viterbi_fwd_banded", "viterbi_backtrace_banded", "estep_gamma_banded")},
    **{name: Kernel(name, "beer_tpu_torch/csrc/hmm_scan.cu")
       for name in ("forward_llh_dense", "estep_acc_dense", "estep_gamma_dense",
                    "forward_llh_shifts_dense", "estep_gamma_dense_restricted")},
    **{name: Kernel(name, "beer_tpu_torch/csrc/general_scan.cu")
       for name in ("scaled_pass", "smoothing_pass")},
    # wrapped in ops/stats_kernels.py
    **{name: Kernel(name, "beer_tpu_torch/csrc/stats_full.cu")
       for name in ("gmm_estep_full", "ellh_full", "accumulate_full")},
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

    One ``nvcc -c`` per source file, all started together, then one
    link.  The ``-Xptxas -v`` reports (registers, shared memory, spills
    per kernel) are kept beside the library as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [f"{tmp}/{src.stem}.o" for src in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                                  stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(srcs, objs)]
        logs = [proc.communicate()[1] for proc in procs]
        if any(proc.returncode for proc in procs):
            raise RuntimeError("nvcc failed:\n" + "".join(logs))
        link = subprocess.run([nvcc, "-shared", "-o", f"{tmp}/lib.so", *objs],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        out.with_suffix(".log").write_text("".join(logs))
        os.replace(f"{tmp}/lib.so", out)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i, z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    signatures = {
        "beer_forward_llh_banded": [i, i, i, i] + [p] * 10 + [i] * 4 + [p],
        "beer_estep_acc_banded": [i, i, i, i] + [p] * 13 + [i] * 5 + [p],
        "beer_estep_gamma_banded": [i, i, i, i] + [p] * 14 + [i] * 5 + [p],
        "beer_viterbi_fwd_banded": [i, i, i, i] + [p] * 7 + [i] * 3 + [p],
        "beer_viterbi_backtrace_banded": [i, i, i, i] + [p] * 6 + [i] * 4 + [p],
        "beer_forward_llh_dense": [i, i, i] + [p] * 10 + [i] * 4 + [p],
        "beer_estep_acc_dense": [i, i, i, i] + [p] * 11 + [i] * 4 + [p],
        "beer_estep_gamma_dense": [i, i, i, i] + [p] * 11 + [i] * 5 + [p],
        "beer_forward_llh_shifts_dense": [i, i, i] + [p] * 9 + [i] * 3 + [p],
        "beer_scaled_pass": [i] * 5 + [p] * 7 + [i] * 3 + [p],
        "beer_smoothing_pass": [i] * 4 + [p] * 10 + [i] * 3 + [p],
        "beer_smoothing_banded": [i, i, i, i] + [p] * 9 + [i] * 3 + [p],
        "beer_gmm_estep_full": [i] + [p] * 6 + [i] * 6 + [p],
        "beer_ellh_full": [i] + [p] * 3 + [i] * 6 + [p],
        "beer_accumulate_full": [i] + [p] * 4 + [i] * 6 + [p],
        "beer_stats_prepare": [i],
    }
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    smem = {"beer_forward_smem_bytes": 5, "beer_estep_smem_bytes": 6, "beer_estep_gamma_smem_bytes": 6,
            "beer_viterbi_smem_bytes": 4, "beer_backtrace_smem_bytes": 3,
            "beer_scaled_pass_smem_bytes": 5, "beer_smoothing_smem_bytes": 4,
            "beer_smoothing_banded_smem_bytes": 4,
            "beer_dense_forward_smem_bytes": 4, "beer_gamma_dense_smem_bytes": 7,
            "beer_acc_dense_smem_bytes": 5}
    for name, n_args in smem.items():
        getattr(lib, name).argtypes = [i] * n_args
        getattr(lib, name).restype = z
    lib.beer_stats_smem_bytes.argtypes = [i] * 5
    lib.beer_stats_smem_bytes.restype = z
    lib.beer_stats_blocks.argtypes = [i] * 6
    lib.beer_stats_blocks.restype = i
    lib.beer_error_string.argtypes = [i]
    lib.beer_error_string.restype = ctypes.c_char_p
    return lib


def refuse_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and an input requires grad: the kernel's
    outputs have no ``grad_fn``, so that input's gradient would be lost."""
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but this kernel has no backward; take the "
            "autograd route (semiring_scan.PhoneLoopLogZ / HMMLogZ / forward_backward_probs, "
            "stats_kernels.EllhFull) or call it under torch.no_grad()")


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


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``: the ``n_sm`` the
    wrappers give the geometry functions."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _utterance_cap(b: int, per_sm: int, n_sm: int) -> int:
    """The most utterances a block that a chunked kernel (K1, K2, and the
    warp instances of K6 and K7) takes at batch size ``b``, one rule for
    all four: the fewest of :data:`ACC_UTTERANCES` whose ceil(b / n)
    blocks run in one wave at ``per_sm`` blocks an SM on ``n_sm`` SMs, the
    most when none does.  Their chains are latency-bound, so fewer
    utterances a block spread a batch over more SMs (kernel alone,
    ``stats_variants.py geometry``: K7 at config 3, B = 128, one a block
    0.20 ms, four 0.33; K1 at config 5, B = 258, one 0.15, four 0.20; K2
    on config 5's loop one 0.22, four 0.35; K6 at B = 128 one 0.39, four
    0.69)."""
    return next((n for n in sorted(ACC_UTTERANCES) if -(-b // n) <= per_sm * n_sm), max(ACC_UTTERANCES))


def _warp_utterances(b: int, n_sm: int, fits) -> int:
    """Utterances a block of a dense warp instance (K6, K7; one block an
    SM, its registers take the SM's file): the most up to
    :func:`_utterance_cap` for which ``fits(n)`` (1 when none does)."""
    cap = _utterance_cap(b, 1, n_sm)
    return next((n for n in ACC_UTTERANCES if n <= cap and fits(n)), 1)


def _fits(what: str, smem: int) -> None:
    if smem > SMEM_LIMIT:
        raise ValueError(f"{what} needs {smem} B of shared memory (> {SMEM_LIMIT}); "
                         "the kernel keeps these operands in shared memory")


# ----------------------------------------------------------------------
# Where the dense kernels keep their (S, S) operands
# ----------------------------------------------------------------------
_MAX_WARPS = 32   # scan_common.cuh kMaxWarps: the block reductions' scratch
_FORWARD = ("forward_llh_dense", "forward_llh_shifts_dense")
_GAMMA = ("estep_gamma_dense", "estep_gamma_dense_restricted")
_DENSE = _FORWARD + ("estep_acc_dense",) + _GAMMA + ("scaled_pass", "smoothing_pass")


def _odd(n: int) -> int:
    return n | 1


def _r4(n: int) -> int:
    return -(-n // 4) * 4


def dense_smem_bytes(kernel: str, s: int, p: int = 0, n_r: int = 0, n_c: int = 0,
                     placement: str = "shared") -> int:
    """Shared memory of one block of a dense kernel (the formulas of
    ``csrc/hmm_scan.cu`` and ``csrc/general_scan.cu``): ``kernel`` one of
    K5 ``forward_llh_dense`` (``p`` > 0 on the stats stream), K14
    ``forward_llh_shifts_dense``, K6 ``estep_acc_dense`` (``p``; its block
    instance at :func:`backward_chunk`'s chunk), K7 ``estep_gamma_dense``
    and K15 ``estep_gamma_dense_restricted`` (``n_r`` × ``n_c``; their
    block instance at :func:`gamma_chunk`'s chunk), K12 ``scaled_pass``
    (the dense forward and reverse) and K13 ``smoothing_pass`` (dense) at
    one utterance a block (:func:`grouped_smem_bytes`);
    ``placement`` "shared" keeps A (and W, K6's moments, the ξ
    accumulator) in shared memory, "global" reads them from device memory.
    K5/K14: their block instance in ``placement`` at
    :func:`forward_chunk`'s chunk (the warp instance's size is
    :func:`forward_smem_bytes`)."""
    if kernel not in _DENSE:
        raise ValueError(f"{kernel} is not a dense kernel")
    if kernel in _FORWARD:
        return forward_smem_bytes(s, p, placement, forward_chunk(s, p, placement))
    elif kernel == "estep_acc_dense":
        return backward_smem_bytes(s, p, placement, backward_chunk(s, p, placement))
    elif kernel in _GAMMA:
        rc = () if kernel == "estep_gamma_dense" else (n_r, n_c)
        return gamma_smem_bytes(s, placement, gamma_chunk(s, placement, *rc), 1, *rc)
    return grouped_smem_bytes(kernel, s, placement)


FORWARD_CHUNK = 32         # K5/K14's warp instance: frames a chunk (hmm_scan.cu kChunk)
FORWARD_CHUNKS = (16, 8, 4, 2, 1)   # the block instance's chunk lengths, the most first (kChunkBlock = 16)
FORWARD_WARPS = 4          # K5/K14's warp instance: utterances a block (kWarps)
_INSTANCES = ("shared", "global", "warp")   # the launchers' instance codes 0, 1, 2


def forward_smem_bytes(s: int, p: int, instance: str, chunk: int = FORWARD_CHUNK) -> int:
    """Shared memory of one K5/K14 block (``hmm_scan.cu``
    ``dense_forward_smem_floats``); ``p`` = 0 on the llh stream, ``chunk``
    the block instance's frames a chunk (the warp instance's is
    ``FORWARD_CHUNK``).  Both instances hold a two-stage ring of a chunk's
    frames and the chunk's e = exp(llh − max) (the block instance on the
    llh stream in the ring stage itself); the block instance also A
    (shared) and W (shared, stats), the warp instance W once for its
    ``FORWARD_WARPS`` utterances."""
    if instance == "warp":
        c = FORWARD_CHUNK
        ldr = _r4(p) if p > 0 else s
        w = _r4(s * (_r4(p) + 1)) if p > 0 else 0
        return 4 * (w + FORWARD_WARPS * (_r4(2 * c * ldr) + c * 33 + c))
    shared = instance == "shared"
    floats = ((_r4(s * _odd(s)) if shared else 0) + 2 * s + 2 * _MAX_WARPS
              + _r4(2 * chunk * (p if p > 0 else s)) + 2 * chunk)
    if p > 0:   # e apart from the ring (on the llh stream e replaces the stage), the bias, W
        floats += chunk * s + s + (s * _odd(p) if shared else 0)
    return 4 * floats


def forward_chunk(s: int, p: int, placement: str) -> int:
    """Frames a chunk of K5/K14's block instance in ``placement``: the most
    of :data:`FORWARD_CHUNKS` whose block fits :data:`SMEM_LIMIT` (1 when
    none does; the launch then refuses it)."""
    return next((c for c in FORWARD_CHUNKS if forward_smem_bytes(s, p, placement, c) <= SMEM_LIMIT), 1)


def forward_instance(s: int, p: int) -> tuple[str, int]:
    """K5/K14's launch, (instance, frames a chunk), decided by fit here and
    nowhere else: ("warp", :data:`FORWARD_CHUNK`) — one warp an utterance,
    the carry passed by shuffles — for S <= 32 while its ring fits a
    block; otherwise the block instance, "shared" while A (and W) fit
    beside a one-frame ring, "global" above, with :func:`forward_chunk`'s
    chunk.  ``p`` = 0 on the llh stream."""
    if s <= 32 and forward_smem_bytes(s, p, "warp") <= SMEM_LIMIT:
        return "warp", FORWARD_CHUNK
    placement = "shared" if forward_smem_bytes(s, p, "shared", 1) <= SMEM_LIMIT else "global"
    return placement, forward_chunk(s, p, placement)


BACKWARD_CHUNK = 16        # K6's warp instance: frames a chunk (acc_chunks.cuh kAccChunk)
BACKWARD_CHUNKS = (16, 8, 4, 2, 1)   # its block instance's chunk lengths (hmm_scan.cu kAccChunkBlock = 16)


def _acc_layout_bytes(s: int, p: int, n_r: int, n_c: int, placement: str, n_utt: int, chunk: int,
                      gamma: bool = False) -> int:
    """Shared memory of one block of the chunked backward (``acc_chunks.cuh``
    ``acc_layout``): ξ (n_r, n_c); ``p`` = 0 is the llh stream (the ring
    holds llh, and there is no W); ``gamma``, the γ-emitting mode, keeps no
    moments."""
    ldg = _r4(s)
    ldx = _r4(p) if p > 0 else ldg
    floats = 6 * ldg + _r4(n_r + n_c)
    if placement == "shared":
        floats += n_r * _r4(n_c) + (_r4(s * (ldx + 1)) + (0 if gamma else s * _r4(p + 1)) if p > 0 else 0)
    per = 2 * chunk * (ldx + ldg) + (chunk + 1) * ldg + chunk * (_r4(n_r) + _r4(n_c)) + _r4(5 * chunk + 2)
    return 4 * (floats + n_utt * per)


def _acc_block_bytes(s: int, p: int, n_r: int, n_c: int, placement: str, chunk: int,
                     gather: bool = False) -> int:
    """Shared memory of one block of K6's and K7's block instance
    (``hmm_scan.cu`` ``acc_block_smem_floats``): a two-stage ring of a
    chunk's statistics (``p`` = 0: llh) and α̂ (one stage in the global
    placement at a one-frame chunk), the chunk's e (with a carry
    row), α̂u1 (on the llh stream in the chunk's llh stage) and the per-frame
    scalars at ``chunk`` frames; with statistics the bias and final
    vectors; when ``gather`` (K15) ξ's
    gathered factors and indices; in the shared placement A, ξ (n_r, n_c)
    and, with statistics, W and the moments."""
    c, ldg = chunk, _r4(s)
    ldx = _r4(p) if p > 0 else ldg
    stages = 1 if placement == "global" and c == 1 else 2
    floats = (((2 * c + 3) * ldg if p > 0 else (c + 1) * ldg) + stages * c * (ldx + ldg) + _r4(5 * c + 2)
              + 2 * _MAX_WARPS)
    if gather:
        floats += c * (_r4(n_r) + _r4(n_c)) + _r4(n_r + n_c)
    if placement == "shared":
        floats += _r4(s * _odd(s)) + n_r * _r4(n_c) + (_r4(s * _odd(p)) + s * _r4(p + 1) if p > 0 else 0)
    return 4 * floats


def backward_utterances(s: int, p: int, b: int, n_sm: int) -> int:
    """Utterances a block of K6's warp instance (K2's kernel in its dense
    mode, ξ over all S states) at batch size ``b`` on ``n_sm`` SMs
    (:func:`_warp_utterances`)."""
    return _warp_utterances(b, n_sm, lambda n: backward_smem_bytes(s, p, "warp", BACKWARD_CHUNK, n) <= SMEM_LIMIT)


def backward_smem_bytes(s: int, p: int, instance: str, chunk: int = BACKWARD_CHUNK, n_utt: int = 1) -> int:
    """Shared memory of one K6 block.  The warp instance is K2's block in
    the shared placement with U = S (``acc_chunks.cuh`` ``acc_layout``) at
    ``n_utt`` utterances; the block instance
    (``hmm_scan.cu`` ``acc_block_smem_floats``) holds a two-stage ring of a
    chunk's statistics and α̂, the chunk's e (with a carry row), α̂u1 and the
    per-frame scalars at ``chunk`` frames, and in the shared placement A, W,
    the moments and ξ."""
    if instance == "warp":
        return acc_banded_smem_bytes(s, p, s, "shared", n_utt, chunk)
    return _acc_block_bytes(s, p, s, s, instance, chunk)


def backward_chunk(s: int, p: int, placement: str) -> int:
    """Frames a chunk of K6's block instance in ``placement``: the most of
    :data:`BACKWARD_CHUNKS` whose block fits (1 when none does; the launch
    then refuses it)."""
    return next((c for c in BACKWARD_CHUNKS if backward_smem_bytes(s, p, placement, c) <= SMEM_LIMIT), 1)


def backward_instance(s: int, p: int) -> tuple[str, int]:
    """K6's launch, (instance, frames a chunk), decided by fit here and
    nowhere else: ("warp", :data:`BACKWARD_CHUNK`) — K2's kernel in its
    dense mode: one warp an utterance's chain, A's row in a lane's
    registers, the carry by shuffles, :func:`backward_utterances` of them
    a block — for S <= 32 while its block fits one utterance; otherwise
    the block instance, "shared" while A, W, the moments and ξ fit beside
    a one-frame chunk, "global" above, with :func:`backward_chunk`'s
    chunk."""
    if s <= 32 and backward_smem_bytes(s, p, "warp") <= SMEM_LIMIT:
        return "warp", BACKWARD_CHUNK
    placement = "shared" if backward_smem_bytes(s, p, "shared", 1) <= SMEM_LIMIT else "global"
    return placement, backward_chunk(s, p, placement)


def gamma_smem_bytes(s: int, instance: str, chunk: int = BACKWARD_CHUNK, n_utt: int = 1,
                     n_r: int | None = None, n_c: int | None = None) -> int:
    """Shared memory of one K7 (``n_r``, ``n_c`` None: ξ over all S
    states) or K15 (ξ (n_r, n_c) at gathered rows and columns) block
    (``hmm_scan.cu`` ``beer_gamma_dense_smem_bytes``): the warp instance is
    the chunked backward's block on the llh stream at ``n_utt``
    utterances, the block instance K6's on the llh stream, both at
    ``chunk`` frames a chunk."""
    restricted = n_r is not None
    n_r, n_c = (n_r, n_c) if restricted else (s, s)
    if instance == "warp":
        return _acc_layout_bytes(s, 0, n_r, n_c, "shared", n_utt, chunk)
    return _acc_block_bytes(s, 0, n_r, n_c, instance, chunk, gather=restricted)


def gamma_chunk(s: int, placement: str, n_r: int | None = None, n_c: int | None = None) -> int:
    """Frames a chunk of K7/K15's block instance in ``placement``: the most
    of :data:`BACKWARD_CHUNKS` whose block fits (1 when none does; the
    launch then refuses it)."""
    return next((c for c in BACKWARD_CHUNKS
                 if gamma_smem_bytes(s, placement, c, 1, n_r, n_c) <= SMEM_LIMIT), 1)


def gamma_instance(s: int, n_r: int | None = None, n_c: int | None = None) -> tuple[str, int]:
    """K7's (``n_r``, ``n_c`` None) and K15's launch, (instance, frames a
    chunk), decided by fit here and nowhere else: K6's kernels in their
    γ-emitting mode, by K6's rule (:func:`backward_instance`): the warp
    instance — the chunked backward's dense mode, one warp an utterance's
    chain, A's row in a lane's registers, :func:`gamma_utterances` of them
    a block — for S <= 32 while its block fits one utterance; otherwise the
    block instance, "shared" while A and ξ fit beside a one-frame chunk,
    "global" above, with :func:`gamma_chunk`'s chunk."""
    if s <= 32 and gamma_smem_bytes(s, "warp", BACKWARD_CHUNK, 1, n_r, n_c) <= SMEM_LIMIT:
        return "warp", BACKWARD_CHUNK
    placement = "shared" if gamma_smem_bytes(s, "shared", 1, 1, n_r, n_c) <= SMEM_LIMIT else "global"
    return placement, gamma_chunk(s, placement, n_r, n_c)


def gamma_utterances(s: int, b: int, n_sm: int, n_r: int | None = None, n_c: int | None = None) -> int:
    """Utterances a block of K7's / K15's warp instance at batch size ``b``
    on ``n_sm`` SMs (:func:`_warp_utterances`; at config 2's B = 514 four
    a block 0.54 ms, one 1.10)."""
    return _warp_utterances(
        b, n_sm, lambda n: gamma_smem_bytes(s, "warp", BACKWARD_CHUNK, n, n_r, n_c) <= SMEM_LIMIT)


def dense_placement(kernel: str, s: int, p: int = 0, n_r: int = 0, n_c: int = 0) -> str:
    """"shared" while a dense kernel's operands fit one block's shared
    memory (:data:`SMEM_LIMIT`), "global" above: every S the reference
    takes runs through the kernel.  K5/K14's comes from
    :func:`forward_instance`, K6's from :func:`backward_instance`, K7's
    and K15's from :func:`gamma_instance` (their warp instances keep A on
    chip too)."""
    if kernel in _FORWARD:
        return "global" if forward_instance(s, p)[0] == "global" else "shared"
    if kernel == "estep_acc_dense":
        return "global" if backward_instance(s, p)[0] == "global" else "shared"
    if kernel in _GAMMA:
        rc = () if kernel == "estep_gamma_dense" else (n_r, n_c)
        return "global" if gamma_instance(s, *rc)[0] == "global" else "shared"
    fits = dense_smem_bytes(kernel, s, p, n_r, n_c, "shared") <= SMEM_LIMIT
    return "shared" if fits else "global"


def _placed(kernel: str, what: str, s: int, p: int = 0, n_r: int = 0, n_c: int = 0) -> bool:
    """The placement of one backward or general-path call (True: global),
    checked against the limit."""
    placement = dense_placement(kernel, s, p, n_r, n_c)
    _fits(what, dense_smem_bytes(kernel, s, p, n_r, n_c, placement))
    return placement == "global"


# ----------------------------------------------------------------------
# Where the banded kernels keep W and their accumulators
# ----------------------------------------------------------------------
ACC_CHUNKS = (16, 8, 4, 2, 1)   # K2's chunk lengths, the most first (phone_loop_scan.cu kAccChunk = 16)
ACC_UTTERANCES = (4, 2, 1)      # K2's utterances a block, the most first
# A block that leaves an SM's shared memory (228 KB, 1 KB reserved a block)
# room for a second one: K2 is launched two blocks an SM where it fits so.
SMEM_SM = 233472            # bytes of shared memory an SM has for its blocks (1 KB of it reserved a block)
SMEM_HALF_SM = SMEM_SM // 2 - 1024


def acc_banded_smem_bytes(s: int, p: int, u: int, placement: str, n_utt: int = 1,
                          chunk: int = ACC_CHUNKS[0]) -> int:
    """Shared memory of one K2 block (``phone_loop_scan.cu`` ``acc_layout``):
    W, the moments and ξ in the shared placement; the bands; and per
    utterance a two-stage ring of a chunk's statistics and α̂, the chunk's
    e (with a carry row), its ξ factors and per-frame sums."""
    return _acc_layout_bytes(s, p, u, u, placement, n_utt, chunk)


def _chunked_geometry(size, b: int, n_sm: int) -> tuple[str, int, int]:
    """The launch of a chunked banded kernel (K1, K2) at batch size ``b`` on
    ``n_sm`` SMs, (placement, utterances a block, frames a chunk), by fit:
    the longest chunk of :data:`ACC_CHUNKS` that fits; then a block that
    leaves its SM room for a second one (:data:`SMEM_HALF_SM`) if one fits
    — a block whose ceil(b / n) blocks are no more than the SMs needs no
    such room; then the most utterances a block up to
    :func:`_utterance_cap` at two blocks an SM, in the "shared" placement if
    it fits there, else "global" (("global", 1, 1) when none does; the
    launch then refuses it).  ``size(placement, n_utt, chunk)``: the
    block's shared memory."""
    cap = _utterance_cap(b, 2, n_sm)
    for chunk in ACC_CHUNKS:
        for limit in (SMEM_HALF_SM, SMEM_LIMIT):
            for n_utt in (n for n in ACC_UTTERANCES if n <= cap):
                room = SMEM_LIMIT if -(-b // n_utt) <= n_sm else limit
                for placement in ("shared", "global"):
                    if size(placement, n_utt, chunk) <= room:
                        return placement, n_utt, chunk
    return "global", 1, 1


def acc_banded_geometry(s: int, p: int, u: int, b: int, n_sm: int) -> tuple[str, int, int]:
    """K2's launch at batch size ``b`` on ``n_sm`` SMs, (placement,
    utterances a block, frames a chunk), decided by fit here and nowhere
    else (:func:`_chunked_geometry`; shared: W, the moments and ξ in shared
    memory).  The chunk comes first, since a short
    chunk puts a barrier-bound pass over the accumulators on every few
    frames; two blocks an SM next, since one block's phases then run while
    the other waits at a barrier (at config 4 two blocks of two utterances
    beat one of four by 12 %, and one of four beat one of two in the shared
    placement by 15 %: ``stats_variants.py geometry``, ``k2n_*``)."""
    return _chunked_geometry(lambda pl, n, c: acc_banded_smem_bytes(s, p, u, pl, n, c), b, n_sm)


def forward_banded_smem_bytes(s: int, p: int, placement: str, n_utt: int = 1,
                              chunk: int = ACC_CHUNKS[0]) -> int:
    """Shared memory of one K1 block (``phone_loop_scan.cu`` ``fwd_layout``):
    W in the shared placement; the bands; and per utterance a two-stage
    ring of a chunk's statistics, the chunk's llh / e / raw rows (with a
    carry row) and its per-frame scalars."""
    ldx, ldg = _r4(p), _r4(s)
    floats = 4 * ldg + (_r4(s * (ldx + 1)) if placement == "shared" else 0)
    per = 2 * chunk * ldx + (chunk + 1) * ldg + _r4(3 * chunk)
    return 4 * (floats + n_utt * per)


def forward_banded_geometry(s: int, p: int, b: int, n_sm: int) -> tuple[str, int, int]:
    """K1's launch at batch size ``b`` on ``n_sm`` SMs, (placement,
    utterances a block, frames a chunk), decided by fit here and nowhere
    else, by K2's rule (:func:`_chunked_geometry`; shared: W in shared
    memory, global: Wᵀ read from device memory).  Measured
    (``stats_variants.py geometry``, kernel alone): config 4 (B = 514) two
    utterances a block with W shared 0.78 ms, four global 0.95; config 5
    (B = 258) one 0.15, four 0.20; 100 units (B = 64) one shared 0.29, two
    global 0.39."""
    return _chunked_geometry(lambda pl, n, c: forward_banded_smem_bytes(s, p, pl, n, c), b, n_sm)


def gamma_banded_smem_bytes(s: int, p: int, u: int, placement: str, n_utt: int = 1,
                            chunk: int = ACC_CHUNKS[0]) -> int:
    """Shared memory of one K11 block: K2's (:func:`acc_banded_smem_bytes`)
    without the moments (``acc_layout`` in the γ-emitting mode)."""
    return _acc_layout_bytes(s, p, u, u, placement, n_utt, chunk, gamma=True)


def gamma_banded_geometry(s: int, p: int, u: int, b: int, n_sm: int) -> tuple[str, int, int]:
    """K11's launch at batch size ``b`` on ``n_sm`` SMs, (placement,
    utterances a block, frames a chunk), decided by fit here and nowhere
    else, by K2's rule (:func:`_chunked_geometry`; shared: W and ξ in shared
    memory, global: Wᵀ from device memory and ξ in the block's partial
    row)."""
    return _chunked_geometry(lambda pl, n, c: gamma_banded_smem_bytes(s, p, u, pl, n, c), b, n_sm)


VIT_WARP_STATES = 192    # K3: one warp an utterance's chain up to this S (32·kVitRegs), a block's above


def viterbi_banded_smem_bytes(s: int, placement: str, n_utt: int = 1, chunk: int = ACC_CHUNKS[0]) -> int:
    """Shared memory of one K3 block (``phone_loop_scan.cu`` ``vit_layout``):
    the bands in the shared placement, the block chain's arg-max scratch;
    and per utterance a two-stage ring of a chunk's llh (α written over
    it), a carry row and two stages of a chunk's staged choices (int8) and
    exit indices."""
    ldg = _r4(s)
    floats = (4 * ldg if placement == "shared" else 0) + 4 * _MAX_WARPS
    per = 2 * chunk * ldg + ldg + 2 * (chunk * ldg // 4 + _r4(chunk))
    return 4 * (floats + n_utt * per)


def viterbi_banded_geometry(s: int, b: int, n_sm: int) -> tuple[str, int, int]:
    """K3's launch at batch size ``b`` on ``n_sm`` SMs, (placement,
    utterances a block, frames a chunk), decided by fit here and nowhere
    else, by K1's rule (:func:`_chunked_geometry`; shared: the bands in
    shared memory, global: read from device memory in the chain); above
    :data:`VIT_WARP_STATES` the whole block walks one utterance's chain, so
    one utterance a block (:func:`viterbi_launch_bytes`)."""
    return _chunked_geometry(lambda pl, n, c: viterbi_launch_bytes(s, pl, n, c), b, n_sm)


def viterbi_launch_bytes(s: int, placement: str, n_utt: int, chunk: int) -> int:
    """:func:`viterbi_banded_smem_bytes` where K3 can take ``n_utt``
    utterances a block (any up to :data:`VIT_WARP_STATES`, one above), more
    than any block has elsewhere."""
    if n_utt > 1 and s > VIT_WARP_STATES:
        return SMEM_LIMIT + 1
    return viterbi_banded_smem_bytes(s, placement, n_utt, chunk)


SMO_WARP_STATES = 192    # K12 / K13 banded: one warp an utterance's chain up to this S (32·kSmoRegs), a block's above


def smoothing_banded_smem_bytes(s: int, placement: str, n_utt: int = 1, chunk: int = ACC_CHUNKS[0]) -> int:
    """Shared memory of one K13 banded block (``general_scan.cu``
    ``smo_layout``): the bands in the shared placement, the block chain's
    partial sums; and per utterance three-stage rings of a chunk's e (v
    written over it) and α̂, C·S contiguous floats each in whole 16-byte
    segments, two stages of its u1 (C, round4(S)) and two of its per-frame
    sums."""
    ldg = _r4(s)
    floats = (4 * ldg if placement == "shared" else 0) + 6 * _MAX_WARPS
    per = 6 * _r4(chunk * s + 6) + 2 * chunk * ldg + 2 * _r4(2 * chunk)
    return 4 * (floats + n_utt * per)


def scaled_banded_smem_bytes(s: int, placement: str, n_utt: int = 1, chunk: int = ACC_CHUNKS[0]) -> int:
    """Shared memory of one K12 banded block (``general_scan.cu``
    ``fwd_layout``): the bands in the shared placement, the block chain's
    partial sums; and per utterance a three-stage ring of a chunk's e (raw
    written over it), C·S contiguous floats a stage in whole 16-byte
    segments, and two stages of its per-frame norms."""
    floats = (4 * _r4(s) if placement == "shared" else 0) + 4 * _MAX_WARPS
    return 4 * (floats + n_utt * (3 * _r4(chunk * s + 6) + 2 * _r4(chunk)))


def _chain_geometry(size, s: int, b: int, n_sm: int) -> tuple[str, int, int]:
    """The launch of a chunked chain kernel (K12 and K13 banded) at batch
    size ``b`` on ``n_sm`` SMs, (placement, utterances a block, frames a
    chunk), by fit.  Its chains are latency-bound, so one wave first: the
    most utterances a block up to :func:`_utterance_cap` at two blocks an SM
    (one above :data:`SMO_WARP_STATES`, where a block walks one utterance);
    then a block that leaves its SM room for a second one
    (:data:`SMEM_HALF_SM`) — a block whose blocks are no more than the SMs
    needs no such room —, the longest chunk of :data:`ACC_CHUNKS`, the bands
    in shared memory ("shared") if they fit there, else read from device
    memory ("global"); ("global", 1, 1) when nothing fits, which the launch
    refuses.  ``size(placement, n_utt, chunk)``: the block's shared
    memory."""
    cap = _utterance_cap(b, 2, n_sm) if s <= SMO_WARP_STATES else 1
    for n_utt in (n for n in ACC_UTTERANCES if n <= cap):
        for limit in (SMEM_HALF_SM, SMEM_LIMIT):
            room = SMEM_LIMIT if -(-b // n_utt) <= n_sm else limit
            for chunk in ACC_CHUNKS:
                for placement in ("shared", "global"):
                    if size(placement, n_utt, chunk) <= room:
                        return placement, n_utt, chunk
    return "global", 1, 1


def smoothing_banded_geometry(s: int, b: int, n_sm: int) -> tuple[str, int, int]:
    """K13 banded's launch at batch size ``b`` on ``n_sm`` SMs, (placement,
    utterances a block, frames a chunk), decided by fit here and nowhere
    else (:func:`_chain_geometry`).  Every S to 7,234 runs."""
    return _chain_geometry(lambda pl, n, c: smoothing_banded_smem_bytes(s, pl, n, c), s, b, n_sm)


def scaled_banded_geometry(s: int, b: int, n_sm: int) -> tuple[str, int, int]:
    """K12 banded's launch at batch size ``b`` on ``n_sm`` SMs, (placement,
    utterances a block, frames a chunk), decided by fit here and nowhere
    else, by K13 banded's rule (:func:`_chain_geometry`).  Every S to
    19,318 runs (the parent's per-frame kernel took S <= 9,674)."""
    return _chain_geometry(lambda pl, n, c: scaled_banded_smem_bytes(s, pl, n, c), s, b, n_sm)


# ----------------------------------------------------------------------
# The dense instances of K12 and K13: a group of utterances a block
# ----------------------------------------------------------------------
GRP_THREADS = 256             # a grouped block's threads (general_scan.cu kGrpThreads)
GRP_UTTERANCES = (8, 4, 2, 1)   # utterances a grouped block, the most first
GRP_MAX_SLICES = 8            # slices of the product's rows at most (kGrpMaxSlices)
GRP_BLOCKS_PER_SM = 2         # grouped blocks an SM holds at most, by registers (__launch_bounds__)


def grouped_slices(s: int) -> int:
    """The slices of M's rows a grouped step splits its product into: the
    most up to :data:`GRP_MAX_SLICES` (and S) whose (column group of four,
    slice) pairs the block's threads hold, so that few threads idle at
    small S; one from S = 513 on, where the column groups fill the block."""
    return max(1, min(GRP_THREADS // -(-s // 4), GRP_MAX_SLICES, s))


def _part_stride(ld: int, n_utt: int) -> int:
    """The stride of a grouped block's partial-sum rows (``general_scan.cu``
    ``grp_part_stride``): at least ``ld``, the ``n_utt`` rows a warp reads at
    once in distinct banks."""
    if n_utt == 1:
        return ld
    m, r = 64 // n_utt, 32 // n_utt
    return ld + ((r - ld % m) % m + m) % m


def grouped_smem_bytes(kernel: str, s: int, placement: str = "shared", n_utt: int = 1) -> int:
    """Shared memory of one grouped block of K12's dense instances
    (``scaled_pass``) or K13's (``smoothing_pass``) (``general_scan.cu``
    ``grp_layout``): M (S, round4(S)) whole in the shared placement, its
    first rows that fit beside the rest in the global one (the others read
    from device memory); the carries (round4(S), n_utt); the
    :func:`grouped_slices` slices of partial sums (n_utt rows each); K13 a
    third array (α̂·u1/ν); a sum a warp, utterance and reduction."""
    ld, ks = _r4(s), grouped_slices(s)
    smo = kernel == "smoothing_pass"
    rest = ld * n_utt * (1 + smo) + ks * n_utt * _part_stride(ld, n_utt) + (3 if smo else 1) * n_utt * _MAX_WARPS
    rows = s if placement == "shared" else min(s, max(SMEM_LIMIT // 4 - rest, 0) // ld)
    return 4 * (rows * ld + rest)


def dense_grouped_geometry(kernel: str, s: int, b: int, n_sm: int) -> tuple[str, int, int]:
    """The launch of a dense instance of K12 (``scaled_pass``, forward and
    reverse) or K13 (``smoothing_pass``) at batch size ``b`` on ``n_sm``
    SMs, (placement, utterances a block, slices), decided by fit here and
    nowhere else: M in shared memory ("shared") while one utterance's block
    holds it, else its first rows there and the others read from device
    memory ("global"); then the fewest utterances of :data:`GRP_UTTERANCES`
    that fit and whose blocks run in one wave at :data:`GRP_BLOCKS_PER_SM`
    blocks an SM where two fit its shared memory, one where one does (the
    global placement's blocks fill it), the most that fit when none does.
    A step's time is mostly latency, so fewer utterances a block cost less
    as long as one wave holds the batch (``stats_variants.py b12_geometry``,
    ``PERF.md`` §6).  Every S to 29,040 (K12) and 19,336 (K13) runs at one
    utterance a block."""
    placement = "shared" if grouped_smem_bytes(kernel, s, "shared") <= SMEM_LIMIT else "global"
    fits = [n for n in GRP_UTTERANCES if grouped_smem_bytes(kernel, s, placement, n) <= SMEM_LIMIT] or [1]

    def per_sm(n):
        return max(1, min(GRP_BLOCKS_PER_SM, SMEM_SM // (grouped_smem_bytes(kernel, s, placement, n) + 1024)))

    n_utt = next((n for n in sorted(fits) if -(-b // n) <= per_sm(n) * n_sm), max(fits))
    return placement, n_utt, grouped_slices(s)


def group_order(lens: torch.Tensor) -> torch.Tensor:
    """The rows in the order the grouped kernels take them, n_utt
    consecutive ones a block: by length, longest first, ties in row order
    (a stable sort), so that a group's steps end near its members' lengths.
    int32, on ``lens``' device; the kernels read and write each row in place
    through it."""
    return torch.argsort(lens, descending=True, stable=True).to(torch.int32)


def _grouped_matrix(m: torch.Tensor) -> torch.Tensor:
    """M (S, S) as the grouped kernels take it: (S, round4(S)), zero
    columns past S, in a fresh (16-byte aligned) allocation."""
    s = m.shape[0]
    out = m.new_zeros(s, _r4(s))
    out[:, :s] = m
    return out


BT_CHUNKS = ACC_CHUNKS      # K4's staged chunk lengths, the most first (at most kAccChunk)
BT_STAGED_STATES = 1024     # K4 stages its choices up to this S and chases them in device memory above
BT_STAGES = 4               # K4: staged chunks in flight a warp (phone_loop_scan.cu kBtStages)
BT_DIRECT_CHUNK = 32        # K4's direct instance: frames a chunk (kBtDirectChunk)
BT_BLOCKS_PER_SM = 8        # K4: blocks of at most four warps an SM holds at once, as the rule counts them


def backtrace_smem_bytes(s: int, n_utt: int = 1, chunk: int = BT_CHUNKS[0]) -> int:
    """Shared memory of one staged K4 block (``phone_loop_scan.cu``
    ``bt_stage_bytes``): per utterance a ring of :data:`BT_STAGES` chunks of
    choices, ``chunk``·S bytes each in whole 16-byte segments."""
    return n_utt * BT_STAGES * ((chunk * s + 30) // 16 * 16)


def backtrace_banded_geometry(s: int, b: int, n_sm: int) -> tuple[str, int, int]:
    """K4's launch at batch size ``b`` on ``n_sm`` SMs, (instance,
    utterances a block, frames a chunk), decided here and nowhere else.
    One warp walks an utterance; a block takes the fewest utterances whose
    blocks run in one wave at :data:`BT_BLOCKS_PER_SM` an SM
    (:func:`_utterance_cap`), so that the chases spread over the SMs.  Up
    to :data:`BT_STAGED_STATES` states "staged" (the choices in shared
    memory) with the longest chunk of :data:`BT_CHUNKS` whose block leaves
    room for the wave's other blocks on an SM, else the longest that fits a
    block (more waves; one frame of four utterances always fits); above,
    "direct" (the chase on device memory, :data:`BT_DIRECT_CHUNK` frames a
    chunk, no shared memory), which takes every S.  A staged chunk moves S
    bytes a frame through one warp, the direct chase one dependent load a
    frame (kernel alone, ``stats_variants.py b13_geometry``, T = 200:
    staged / direct 0.024 / 0.045 ms at S = 300, 0.037 / 0.046 at 750,
    0.065 / 0.047 at 2,100, 0.229 / 0.055 at 9,600)."""
    n_utt = _utterance_cap(b, BT_BLOCKS_PER_SM, n_sm)
    if s > BT_STAGED_STATES:
        return "direct", n_utt, BT_DIRECT_CHUNK
    per_sm = max(-(-(-(-b // n_utt)) // n_sm), 1)
    room = min(SMEM_SM // per_sm - 1024, SMEM_LIMIT)
    fits = ([c for c in BT_CHUNKS if backtrace_smem_bytes(s, n_utt, c) <= room]
            or [c for c in BT_CHUNKS if backtrace_smem_bytes(s, n_utt, c) <= SMEM_LIMIT])  # one frame always fits
    return "staged", n_utt, fits[0]


def banded_placement(kernel: str, s: int, p: int, u: int, b: int, n_sm: int) -> str:
    """"shared" while a banded kernel's W (and K2's moments and ξ, K11's ξ;
    K3's bands) fit one block's shared memory beside its chunks, "global"
    above: every phone loop the reference takes runs through K1, K2, K3 and
    K11.  It depends on the batch size ``b`` and the ``n_sm`` SMs and comes
    from the kernel's launch: :func:`forward_banded_geometry`,
    :func:`acc_banded_geometry`, :func:`gamma_banded_geometry` or
    :func:`viterbi_banded_geometry` (which reads neither ``p`` nor ``u``)."""
    geometries = {"forward_llh_banded": lambda: forward_banded_geometry(s, p, b, n_sm),
                  "estep_acc_banded": lambda: acc_banded_geometry(s, p, u, b, n_sm),
                  "estep_gamma_banded": lambda: gamma_banded_geometry(s, p, u, b, n_sm),
                  "viterbi_fwd_banded": lambda: viterbi_banded_geometry(s, b, n_sm)}
    if kernel not in geometries:
        raise ValueError(f"{kernel} is not a banded scan kernel")
    return geometries[kernel]()[0]


def _shift_down(x: torch.Tensor) -> torch.Tensor:
    """y[..., j] = x[..., j−1]; y[..., 0] = 0."""
    return torch.nn.functional.pad(x[..., :-1], (1, 0))


def _shift_up(x: torch.Tensor) -> torch.Tensor:
    """y[..., j] = x[..., j+1]; y[..., −1] = 0."""
    return torch.nn.functional.pad(x[..., 1:], (0, 1))


def _band_propagators(bands):
    """(forward p ↦ pA, backward v ↦ Av) through A = diag(a_self) +
    superdiag(a_adv) + exit ⊗ w, for ``bands`` (4, S) = [a_self, a_adv,
    exit, w]: lane 0 takes no advance, the last lane gives none."""
    a_self, a_adv, exit_v, w_v = bands

    def forward(p):
        q = (p * exit_v).sum(-1, keepdim=True)
        return p * a_self + _shift_down(p * a_adv) + q * w_v

    def backward(v):
        r = (v * w_v).sum(-1, keepdim=True)
        return v * a_self + _shift_up(v) * a_adv + r * exit_v

    return forward, backward


def _prefix_mask(lens: torch.Tensor, t_len: int, like: torch.Tensor) -> torch.Tensor:
    """(B, T) prefix mask of ``lens`` in ``like``'s dtype, on its device."""
    steps = torch.arange(t_len, device=like.device)
    return (steps[None, :] < lens.to(like.device)[:, None]).to(like.dtype)


# ----------------------------------------------------------------------
# The plain recursions shared by the banded and the dense kernels
# ----------------------------------------------------------------------
def _forward_plain(llh, lens, init, propagate, shifts: bool = False):
    """Scaled forward of K1 and K5: α̂_t = normalise(propagate(α̂_{t−1}) ⊙
    exp(llh_t − max)), α̂_0 from ``init`` ((S,) or (B, S)).  Returns (α̂,
    norms, last, logz_base) as the kernels do.

    ``shifts`` is K14's contract: frame 0 fires on every row (an empty
    row sees e = 1 there), frames t >= max(len, 1) copy the carry into α̂,
    and the masked row maxima (B, T) are returned as a fifth output."""
    b, t_len, s = llh.shape
    tiny = torch.finfo(llh.dtype).tiny
    lens = lens.to(llh.device)
    alpha = llh.new_zeros(b, t_len, s)
    norms = llh.new_ones(b, t_len)
    shift = llh.new_zeros(b, t_len) if shifts else None
    logz = llh.new_zeros(b)
    p = init.expand(b, s).clone()
    n_steps = _max_len(lens)
    if shifts:
        n_steps = min(max(n_steps, 1), t_len)
    for t in range(n_steps):
        real = (t < lens)[:, None]
        valid = real | (t == 0) if shifts else real
        llh_t = torch.where(real, llh[:, t], 0.0) if shifts else llh[:, t]
        mx = llh_t.max(-1, keepdim=True).values
        base = p if t == 0 else propagate(p)
        raw = base * torch.exp(llh_t - mx)
        norm = raw.sum(-1, keepdim=True).clamp_min(tiny)
        p_new = raw / norm
        p = torch.where(valid, p_new, p)
        alpha[:, t] = p if shifts else torch.where(valid, p_new, 0.0)
        norms[:, t] = torch.where(valid, norm, 1.0)[:, 0]
        if shifts:
            shift[:, t] = torch.where(real, mx, 0.0)[:, 0]
        logz = torch.where(valid[:, 0], logz + (torch.log(norm) + mx)[:, 0], logz)
    if not shifts:
        return alpha, norms, p, logz
    alpha[:, n_steps:] = p[:, None]
    return alpha, norms, p, logz, shift


def _backward_plain(llh, lens, final, alpha, norms, propagate_t, stats=None, rows=None,
                    cols=None):
    """v-space backward of K2, K6 and K7 over the stored forward: u1 =
    ``final`` at each row's last frame, else propagate_t(v̂_{t+1}) = A v̂.

    Returns (γ (B, T, S), or with ``stats`` acc (S, P+1) = Σ γ ⊗ [stats,
    1]), γ0 (B, S) and ξ_raw = Σ_t (α̂_t·wgt_{t+1}) ⊗ v̂_{t+1}, (S, S) or
    restricted to ``[rows][:, cols]`` by an exact gather."""
    b, t_len, s = llh.shape
    tiny = torch.finfo(llh.dtype).tiny
    lens = lens.to(llh.device)
    if stats is None:
        gamma = llh.new_zeros(b, t_len, s)
    else:
        acc = llh.new_zeros(s, stats.shape[-1] + 1)
        ones = llh.new_ones(b, 1)
    gamma0 = llh.new_zeros(b, s)
    n_r, n_c = (s, s) if rows is None else (rows.shape[0], cols.shape[0])
    xi = llh.new_zeros(n_r, n_c)
    v_hat = llh.new_zeros(b, s)
    wgt_next = llh.new_zeros(b, 1)
    for t in range(_max_len(lens) - 1, -1, -1):
        valid = (t < lens)[:, None]
        is_last = (t == lens - 1)[:, None]
        llh_t = llh[:, t]
        e = torch.exp(llh_t - llh_t.max(-1, keepdim=True).values)
        u1 = torch.where(is_last, final, propagate_t(v_hat))
        v = e * u1
        ab = alpha[:, t] * u1
        sv = v.sum(-1, keepdim=True).clamp_min(tiny)
        absum = ab.sum(-1, keepdim=True)
        g = torch.where(valid, ab / absum.clamp_min(tiny), 0.0)
        denom = norms[:, t, None] * absum / sv
        wgt = torch.where(valid & (denom > XI_FLOOR), 1.0 / denom.clamp_min(XI_FLOOR), 0.0)
        if stats is None:
            gamma[:, t] = g
        else:
            acc += g.T @ torch.cat([stats[:, t], ones], dim=-1)
        u, w = alpha[:, t], v_hat
        if rows is not None:
            u, w = u[:, rows], w[:, cols]
        xi += torch.where(valid & ~is_last, u * wgt_next, 0.0).T @ w
        v_hat = torch.where(valid, v / sv, v_hat)
        wgt_next = wgt
        if t == 0:
            gamma0 = g
    return (gamma if stats is None else acc), gamma0, xi


# ----------------------------------------------------------------------
# K1: scaled banded forward with in-kernel ELLH
# ----------------------------------------------------------------------
def forward_llh_banded_plain(stats, lens, w, bias, bands, init):
    """Plain version of :func:`forward_llh_banded` (any dtype and device)."""
    return _forward_plain(torch.matmul(stats, w.T) + bias, lens, init,
                          _band_propagators(bands)[0])


@scoped("beer.kernel.forward_llh_banded")
def forward_llh_banded(stats, lens, w, bias, bands, init):
    """Scaled forward through band + rank-1 phone-loop transitions, with
    llh = W·stats + bias computed in the kernel (llh never stored).

    Returns ``alpha`` (B, T, S) per-frame normalised α̂ (0 on frames
    t >= len), ``norms`` (B, T) per-step normalisers (1 there), ``last``
    (B, S) = α̂ at the last frame (``init`` for empty rows) and
    ``logz_base`` (B,) = Σ_t log norm_t + max_s llh_t (0 for empty rows);
    log Z = logz_base + log Σ last·final.
    """
    refuse_grad("forward_llh_banded", stats, w, bias, bands, init)
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
    placement, n_utt, chunk = forward_banded_geometry(s, p_dim, b, sm_count(dev.index))
    glob = placement == "global"
    _fits(f"S={s}, P={p_dim}", lib.beer_forward_smem_bytes(s, p_dim, int(glob), n_utt, chunk))
    if glob:   # Wᵀ with zero rows to a multiple of four
        w = torch.nn.functional.pad(w, (0, -p_dim % 4)).T.contiguous()
    alpha = torch.empty(b, t_len, s, device=dev)
    norms = torch.empty(b, t_len, device=dev)
    last = torch.empty(b, s, device=dev)
    logz = torch.empty(b, device=dev)
    _launch(lib.beer_forward_llh_banded, dev.index, int(glob), n_utt, chunk, *map(_ptr, (
        stats, lens, w, bias, bands, init, alpha, norms, last, logz)),
        b, t_len, s, p_dim, _stream(dev))
    KERNELS["forward_llh_banded"].launches += 1
    return alpha, norms, last, logz


# ----------------------------------------------------------------------
# K2: accumulating v-space backward (γ moments, γ0, loop-back ξ)
# ----------------------------------------------------------------------
def _banded_backward_plain(stats, lens, w, bias, bands, final, alpha, norms, ends, starts,
                           accumulate: bool):
    """K2's (``accumulate``) or K11's plain version: the v-space backward
    through band + rank-1 transitions, v ↦ v·a_self + shift_up(v)·a_adv +
    (v·w)·exit."""
    return _backward_plain(torch.matmul(stats, w.T) + bias, lens, final, alpha, norms,
                           _band_propagators(bands)[1], stats if accumulate else None,
                           ends.long(), starts.long())


def _check_banded_backward(stats, lens, w, bias, bands, final, alpha, norms, ends, starts):
    """K2's and K11's operand checks; returns (B, T, P, S, U)."""
    b, t_len, p_dim = stats.shape
    s = w.shape[0]
    n_u = ends.shape[0]
    _check(dict(stats=stats, lens=lens, w=w, bias=bias, bands=bands, final=final,
                alpha=alpha, norms=norms, ends=ends, starts=starts), stats.device,
           dict(lens=torch.int32, ends=torch.int32, starts=torch.int32))
    for name, x, shape in (("lens", lens, (b,)), ("w", w, (s, p_dim)), ("bias", bias, (s,)),
                           ("bands", bands, (4, s)), ("final", final, (s,)),
                           ("alpha", alpha, (b, t_len, s)), ("norms", norms, (b, t_len)),
                           ("ends", ends, (n_u,)), ("starts", starts, (n_u,))):
        _shape(name, x, shape)
    return b, t_len, p_dim, s, n_u


def estep_acc_banded_plain(stats, lens, w, bias, bands, final, alpha, norms, ends, starts):
    """Plain version of :func:`estep_acc_banded` (any dtype and device)."""
    p_dim = stats.shape[-1]
    acc, gamma0, xi = _banded_backward_plain(stats, lens, w, bias, bands, final, alpha, norms,
                                             ends, starts, accumulate=True)
    return acc[:, :p_dim], acc[:, p_dim], gamma0, xi


@scoped("beer.kernel.estep_acc_banded")
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
    refuse_grad("estep_acc_banded", stats, w, bias, bands, final, alpha, norms)
    if stats.device.type == "cpu":
        return estep_acc_banded_plain(stats, lens, w, bias, bands, final, alpha, norms,
                                      ends, starts)
    b, t_len, p_dim, s, n_u = _check_banded_backward(stats, lens, w, bias, bands, final, alpha,
                                                     norms, ends, starts)
    dev = stats.device
    lib = _library()
    placement, n_utt, chunk = acc_banded_geometry(s, p_dim, n_u, b, sm_count(dev.index))
    glob = placement == "global"
    _fits(f"S={s}, P={p_dim}, U={n_u}", lib.beer_estep_smem_bytes(s, p_dim, n_u, int(glob), n_utt, chunk))
    if glob:   # Wᵀ with zero rows to a multiple of four
        w = torch.nn.functional.pad(w, (0, -p_dim % 4)).T.contiguous()
    width = s * (p_dim + 1) + n_u * n_u
    part = torch.empty(-(-b // n_utt), width, device=dev)     # a row a block of n_utt utterances
    out = torch.empty(width, device=dev)
    gamma0 = torch.empty(b, s, device=dev)
    _launch(lib.beer_estep_acc_banded, dev.index, int(glob), n_utt, chunk, *map(_ptr, (
        stats, lens, w, bias, bands, final, alpha, norms, ends, starts, part, out, gamma0)),
        b, t_len, s, p_dim, n_u, _stream(dev))
    KERNELS["estep_acc_banded"].launches += 1
    acc = out[: s * (p_dim + 1)].view(s, p_dim + 1)
    return acc[:, :p_dim], acc[:, p_dim], gamma0, out[s * (p_dim + 1):].view(n_u, n_u)


# ----------------------------------------------------------------------
# K11: γ-emitting banded v-space backward (γ, γ0, loop-back ξ)
# ----------------------------------------------------------------------
def estep_gamma_banded_plain(stats, lens, w, bias, bands, final, alpha, norms, ends, starts):
    """Plain version of :func:`estep_gamma_banded` (any dtype and device)."""
    return _banded_backward_plain(stats, lens, w, bias, bands, final, alpha, norms, ends, starts,
                                  accumulate=False)


@scoped("beer.kernel.estep_gamma_banded")
def estep_gamma_banded(stats, lens, w, bias, bands, final, alpha, norms, ends, starts):
    """Backward smoothing pass through band + rank-1 transitions that emits
    the state posteriors, with llh = stats @ wᵀ + bias computed in the
    kernel: the backward of the phone loop's log Z (∂log Z/∂llh = γ).

    Takes the operands of :func:`estep_acc_banded`.  Returns ``gamma``
    (B, T, S) (0 on frames t >= len), ``gamma0`` (B, S) = γ at the first
    frame and ``xi_raw`` (U, U) as :func:`estep_acc_banded` does.
    """
    refuse_grad("estep_gamma_banded", stats, w, bias, bands, final, alpha, norms)
    if stats.device.type == "cpu":
        return estep_gamma_banded_plain(stats, lens, w, bias, bands, final, alpha, norms,
                                        ends, starts)
    b, t_len, p_dim, s, n_u = _check_banded_backward(stats, lens, w, bias, bands, final, alpha,
                                                     norms, ends, starts)
    dev = stats.device
    lib = _library()
    placement, n_utt, chunk = gamma_banded_geometry(s, p_dim, n_u, b, sm_count(dev.index))
    glob = placement == "global"
    _fits(f"S={s}, P={p_dim}, U={n_u}", lib.beer_estep_gamma_smem_bytes(s, p_dim, n_u, int(glob), n_utt, chunk))
    if glob:   # Wᵀ with zero rows to a multiple of four
        w = torch.nn.functional.pad(w, (0, -p_dim % 4)).T.contiguous()
    part = torch.empty(-(-b // n_utt), n_u * n_u, device=dev)     # a row a block of n_utt utterances
    out = torch.empty(n_u * n_u, device=dev)
    gamma0 = torch.empty(b, s, device=dev)
    gamma = torch.empty(b, t_len, s, device=dev)
    _launch(lib.beer_estep_gamma_banded, dev.index, int(glob), n_utt, chunk, *map(_ptr, (
        stats, lens, w, bias, bands, final, alpha, norms, ends, starts, part, out, gamma0, gamma)),
        b, t_len, s, p_dim, n_u, _stream(dev))
    KERNELS["estep_gamma_banded"].launches += 1
    return gamma, gamma0, out.view(n_u, n_u)


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


@scoped("beer.kernel.viterbi_fwd_banded")
def viterbi_fwd_banded(llh, lens, log_bands, log_init):
    """(max,+) forward through the band + rank-1 factorisation.

    ``llh`` (B, T, S) state log-likelihoods, ``log_bands`` (4, S) the
    log of ``bands`` (−1e30 where a band is 0), ``log_init`` (S,).
    Returns ``choices`` (B, T, S) int8 in {0 stay, 1 advance, 2 loop}
    (0 on frame 0 and on frames t >= len), ``exarg`` (B, T) int32 exit
    arg-max per step (smallest index on ties) and ``alpha_last`` (B, S).
    """
    refuse_grad("viterbi_fwd_banded", llh, log_bands, log_init)
    if llh.device.type == "cpu":
        return viterbi_fwd_banded_plain(llh, lens, log_bands, log_init)
    b, t_len, s = llh.shape
    dev = llh.device
    _check(dict(llh=llh, lens=lens, log_bands=log_bands, log_init=log_init), dev,
           dict(lens=torch.int32))
    for name, x, shape in (("lens", lens, (b,)), ("log_bands", log_bands, (4, s)),
                           ("log_init", log_init, (s,))):
        _shape(name, x, shape)
    lib = _library()
    placement, n_utt, chunk = viterbi_banded_geometry(s, b, sm_count(dev.index))
    glob = placement == "global"
    _fits(f"S={s}", lib.beer_viterbi_smem_bytes(s, int(glob), n_utt, chunk))
    choices = torch.empty(b, t_len, s, dtype=torch.int8, device=dev)
    exarg = torch.empty(b, t_len, dtype=torch.int32, device=dev)
    alpha_last = torch.empty(b, s, device=dev)
    _launch(lib.beer_viterbi_fwd_banded, dev.index, int(glob), n_utt, chunk, *map(_ptr, (
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


@scoped("beer.kernel.viterbi_backtrace_banded")
def viterbi_backtrace_banded(choices, exarg, alpha_last, log_final):
    """Best paths from :func:`viterbi_fwd_banded`'s outputs.

    ``log_final`` is (S,) or per utterance (B, S).  Returns ``paths``
    (B, T) int32 state ids (frames past an utterance's end repeat its
    last state) and ``scores`` (B,) = max_s α_last + log_final, whose
    arg-max (first on ties) ends the path.
    """
    refuse_grad("viterbi_backtrace_banded", alpha_last, log_final)
    if choices.device.type == "cpu":
        return viterbi_backtrace_banded_plain(choices, exarg, alpha_last, log_final)
    b, t_len, s = choices.shape
    dev = choices.device
    _check(dict(choices=choices, exarg=exarg, alpha_last=alpha_last, log_final=log_final), dev,
           dict(choices=torch.int8, exarg=torch.int32))
    per_row = log_final.ndim == 2
    for name, x, shape in (("exarg", exarg, (b, t_len)), ("alpha_last", alpha_last, (b, s)),
                           ("log_final", log_final, (b, s) if per_row else (s,))):
        _shape(name, x, shape)
    lib = _library()
    instance, n_utt, chunk = backtrace_banded_geometry(s, b, sm_count(dev.index))
    staged = instance == "staged"
    if staged:
        _fits(f"S={s}", lib.beer_backtrace_smem_bytes(s, n_utt, chunk))
    paths = torch.empty(b, t_len, dtype=torch.int32, device=dev)
    scores = torch.empty(b, device=dev)
    _launch(lib.beer_viterbi_backtrace_banded, dev.index, int(staged), n_utt, chunk, *map(_ptr, (
        choices, exarg, alpha_last, log_final, paths, scores)),
        b, t_len, s, s if per_row else 0, _stream(dev))
    KERNELS["viterbi_backtrace_banded"].launches += 1
    return paths, scores


# ----------------------------------------------------------------------
# K5: scaled dense forward (llh stream, or stats with in-kernel ELLH)
# ----------------------------------------------------------------------
def forward_llh_dense_plain(x, lens, trans, init, w=None, bias=None, return_shifts=False):
    """Plain version of :func:`forward_llh_dense` (any dtype and device)."""
    llh = x if w is None else torch.matmul(x, w.T) + bias
    return _forward_plain(llh, lens, init, lambda p: p @ trans, shifts=return_shifts)


@scoped(lambda return_shifts, **_: "beer.kernel.forward_llh_shifts_dense" if return_shifts
        else "beer.kernel.forward_llh_dense")
def forward_llh_dense(x, lens, trans, init, w=None, bias=None, return_shifts=False):
    """Scaled forward through a dense (S, S) transition matrix:
    α̂_t = normalise(Aᵀ α̂_{t−1} ⊙ exp(llh_t − max)), α̂_0 from ``init``.

    ``x`` is the llh stream (B, T, S), or with ``w`` (S, P) and ``bias``
    (S,) the reduced statistics (B, T, P) with llh = x @ wᵀ + bias
    computed in the kernel.  ``init`` (B, S).  Returns ``alpha`` (B, T,
    S) (0 on frames t >= len), ``norms`` (B, T) per-step normalisers (1
    there), ``last`` (B, S) = α̂ at the last frame (``init`` for empty
    rows) and ``logz_base`` (B,); log Z = logz_base + log Σ last·final.

    ``return_shifts`` (llh stream only) is K14, ``forward_llh_shifts_dense``:
    a fifth output ``shifts`` (B, T) holds the row max of each frame t <
    len (0 after), so that ``logz_base`` = Σ_t log norm_t + Σ_t shift_t.
    Its contract on masked frames is the general path's, not K5's: frame
    0 fires on every row (an empty row carries normalise(init), with
    norm_0 = Σ init), and α̂ on frames t >= max(len, 1) repeats the last
    valid α̂ instead of 0.
    """
    refuse_grad("forward_llh_shifts_dense" if return_shifts else "forward_llh_dense",
                x, trans, init, w, bias)
    if return_shifts and w is not None:
        raise ValueError("return_shifts reads the llh stream: pass no w/bias")
    if x.device.type == "cpu":
        return forward_llh_dense_plain(x, lens, trans, init, w, bias, return_shifts)
    b, t_len, width = x.shape
    s = trans.shape[0]
    dev = x.device
    stats_mode = w is not None
    operands = dict(x=x, lens=lens, trans=trans, init=init)
    shapes = [("lens", lens, (b,)), ("trans", trans, (s, s)), ("init", init, (b, s))]
    if stats_mode:
        operands.update(w=w, bias=bias)
        shapes += [("w", w, (s, width)), ("bias", bias, (s,))]
    else:
        shapes.append(("x", x, (b, t_len, s)))
    _check(operands, dev, dict(lens=torch.int32))
    for name, t, shape in shapes:
        _shape(name, t, shape)
    p_dim = width if stats_mode else 0
    lib = _library()
    instance, chunk = forward_instance(s, p_dim)
    _fits(f"S={s}, P={p_dim}", forward_smem_bytes(s, p_dim, instance, chunk))
    if instance == "global" and stats_mode:
        w = w.T.contiguous()
    code = _INSTANCES.index(instance)
    alpha = torch.empty(b, t_len, s, device=dev)
    norms = torch.empty(b, t_len, device=dev)
    last = torch.empty(b, s, device=dev)
    logz = torch.empty(b, device=dev)
    if return_shifts:
        shifts = torch.empty(b, t_len, device=dev)
        _launch(lib.beer_forward_llh_shifts_dense, dev.index, code, chunk, *map(_ptr, (
            x, lens, trans, init, alpha, norms, last, logz, shifts)), b, t_len, s, _stream(dev))
        KERNELS["forward_llh_shifts_dense"].launches += 1
        return alpha, norms, last, logz, shifts
    _launch(lib.beer_forward_llh_dense, dev.index, code, chunk, *map(_ptr, (x, lens)),
            _ptr(w) if stats_mode else None, _ptr(bias) if stats_mode else None,
            *map(_ptr, (trans, init, alpha, norms, last, logz)), b, t_len, s, p_dim, _stream(dev))
    KERNELS["forward_llh_dense"].launches += 1
    return alpha, norms, last, logz


# ----------------------------------------------------------------------
# K6 / K7: dense v-space backward (accumulating / γ-emitting), full ξ
# ----------------------------------------------------------------------
def estep_acc_dense_plain(stats, lens, w, bias, trans, final, alpha, norms):
    """Plain version of :func:`estep_acc_dense` (any dtype and device)."""
    p_dim = stats.shape[-1]
    acc, gamma0, xi = _backward_plain(torch.matmul(stats, w.T) + bias, lens, final, alpha, norms,
                                      lambda v: v @ trans.T, stats)
    return acc[:, :p_dim], acc[:, p_dim], gamma0, xi


@scoped("beer.kernel.estep_acc_dense")
def estep_acc_dense(stats, lens, w, bias, trans, final, alpha, norms):
    """Backward smoothing pass over a dense (S, S) matrix that reduces γ
    in the kernel, with llh = stats @ wᵀ + bias computed there.

    Takes :func:`forward_llh_dense`'s ``alpha`` and ``norms`` and the
    per-utterance ``final`` (B, S).  Returns ``acc2`` (S, P) = Σ_{b,t} γ
    ⊗ stats, ``counts`` (S,) = Σ γ, ``gamma0`` (B, S) = γ at the first
    frame and ``xi_raw`` (S, S) = Σ_t (α̂_t·wgt_{t+1}) ⊗ v̂_{t+1}; the
    expected transition counts are ``xi_raw ⊙ trans``.  γ is never stored.
    """
    refuse_grad("estep_acc_dense", stats, w, bias, trans, final, alpha, norms)
    if stats.device.type == "cpu":
        return estep_acc_dense_plain(stats, lens, w, bias, trans, final, alpha, norms)
    b, t_len, p_dim = stats.shape
    s = trans.shape[0]
    dev = stats.device
    _check(dict(stats=stats, lens=lens, w=w, bias=bias, trans=trans, final=final,
                alpha=alpha, norms=norms), dev, dict(lens=torch.int32))
    for name, x, shape in (("lens", lens, (b,)), ("w", w, (s, p_dim)), ("bias", bias, (s,)),
                           ("trans", trans, (s, s)), ("final", final, (b, s)),
                           ("alpha", alpha, (b, t_len, s)), ("norms", norms, (b, t_len))):
        _shape(name, x, shape)
    lib = _library()
    instance, chunk = backward_instance(s, p_dim)
    n_utt = backward_utterances(s, p_dim, b, sm_count(dev.index)) if instance == "warp" else 1
    _fits(f"S={s}, P={p_dim}", backward_smem_bytes(s, p_dim, instance, chunk, n_utt))
    if instance == "global":
        w, trans = w.T.contiguous(), trans.T.contiguous()
    width = s * (p_dim + 1) + s * s
    part = torch.empty(-(-b // n_utt), width, device=dev)    # a row a block
    out = torch.empty(width, device=dev)
    gamma0 = torch.empty(b, s, device=dev)
    _launch(lib.beer_estep_acc_dense, dev.index, _INSTANCES.index(instance), chunk, n_utt, *map(_ptr, (
        stats, lens, w, bias, trans, final, alpha, norms, part, out, gamma0)),
        b, t_len, s, p_dim, _stream(dev))
    KERNELS["estep_acc_dense"].launches += 1
    acc = out[: s * (p_dim + 1)].view(p_dim + 1, s).T       # written state-minor
    return acc[:, :p_dim], acc[:, p_dim], gamma0, out[s * (p_dim + 1):].view(s, s)


def estep_gamma_dense_plain(llh, lens, trans, final, alpha, norms, rows=None, cols=None):
    """Plain version of :func:`estep_gamma_dense` (any dtype and device)."""
    if rows is not None:
        rows, cols = rows.long(), cols.long()
    gamma, _, xi = _backward_plain(llh, lens, final, alpha, norms, lambda v: v @ trans.T,
                                   rows=rows, cols=cols)
    return gamma, xi


@scoped(lambda rows, **_: "beer.kernel.estep_gamma_dense" if rows is None
        else "beer.kernel.estep_gamma_dense_restricted")
def estep_gamma_dense(llh, lens, trans, final, alpha, norms, rows=None, cols=None):
    """Backward smoothing pass over a dense (S, S) matrix that emits the
    state posteriors.

    Takes the llh stream (B, T, S), :func:`forward_llh_dense`'s ``alpha``
    and ``norms`` and the per-utterance ``final`` (B, S).  Returns ``gamma``
    (B, T, S) (0 on frames t >= len) and ``xi_raw`` (S, S) as
    :func:`estep_acc_dense` does.

    With ``rows`` (n_r,) and ``cols`` (n_c,) int32 state indices it is K15,
    ``estep_gamma_dense_restricted``: ``xi_raw`` is the block
    ``[rows][:, cols]``, (n_r, n_c), gathered in the kernel (exactly; no
    one-hot product), so only n_r·n_c floats per utterance are reduced.
    """
    refuse_grad("estep_gamma_dense" if rows is None else "estep_gamma_dense_restricted",
                llh, trans, final, alpha, norms)
    if (rows is None) != (cols is None):
        raise ValueError("rows and cols restrict ξ together: pass both or neither")
    if llh.device.type == "cpu":
        return estep_gamma_dense_plain(llh, lens, trans, final, alpha, norms, rows, cols)
    b, t_len, s = llh.shape
    dev = llh.device
    operands = dict(llh=llh, lens=lens, trans=trans, final=final, alpha=alpha, norms=norms)
    shapes = [("lens", lens, (b,)), ("trans", trans, (s, s)), ("final", final, (b, s)),
              ("alpha", alpha, (b, t_len, s)), ("norms", norms, (b, t_len))]
    restricted = rows is not None
    if restricted:
        operands.update(rows=rows, cols=cols)
        shapes += [("rows", rows, (rows.numel(),)), ("cols", cols, (cols.numel(),))]
    _check(operands, dev, dict(lens=torch.int32, rows=torch.int32, cols=torch.int32))
    for name, x, shape in shapes:
        _shape(name, x, shape)
    lib = _library()
    rc = (rows.numel(), cols.numel()) if restricted else ()
    n_r, n_c = rc or (s, s)
    if restricted:
        for name, idx in (("rows", rows), ("cols", cols)):
            if idx.numel() and not bool(((idx >= 0) & (idx < s)).all()):
                raise ValueError(f"{name} holds a state index outside [0, {s})")
    instance, chunk = gamma_instance(s, *rc)
    n_utt = gamma_utterances(s, b, sm_count(dev.index), *rc) if instance == "warp" else 1
    code = _INSTANCES.index(instance)
    _fits(f"S={s}, n_r={n_r}, n_c={n_c}",
          lib.beer_gamma_dense_smem_bytes(s, n_r, n_c, int(restricted), code, chunk, n_utt))
    if instance == "global":   # Aᵀ, held until the launch
        trans = trans.T.contiguous()
    gamma = torch.empty(b, t_len, s, device=dev)
    part = torch.empty(-(-b // n_utt), n_r * n_c, device=dev)     # a row a block
    out = torch.zeros(n_r * n_c, device=dev)
    _launch(lib.beer_estep_gamma_dense, dev.index, code, chunk, n_utt, *map(_ptr, (
        llh, lens, trans, final, alpha, norms)),
        _ptr(rows) if restricted else None, _ptr(cols) if restricted else None,
        *map(_ptr, (part, out, gamma)), b, t_len, s, n_r, n_c, _stream(dev))
    KERNELS["estep_gamma_dense_restricted" if restricted else "estep_gamma_dense"].launches += 1
    return gamma, out.view(n_r, n_c)


# ----------------------------------------------------------------------
# K12 / K13: the general path's scaled passes and smoothing over e_llh
# ----------------------------------------------------------------------
def scaled_loop(e_llh, mask, vec, step, reverse: bool = False):
    """The scaled recursion of the general path, differentiable.

    Forward: p_0 = normalise(vec ⊙ e_0), p_t = normalise(step(p_{t−1}) ⊙
    e_t).  Reverse (the β̂ pass): the carry starts at normalise(vec), and
    frame t stores normalise(step(p_{t+1} ⊙ e_{t+1})), consuming e and the
    mask at t + 1.  Masked steps copy the carry into the outputs.
    ``step`` maps (B, S) to (B, S): p ↦ pA forward, v ↦ Av in reverse.
    Returns (probs (B, T, S), cumulative log-scales (B, T))."""
    tiny = torch.finfo(e_llh.dtype).tiny
    t_len = e_llh.shape[1]
    prob = vec if reverse else vec * e_llh[:, 0]
    norm = prob.sum(-1, keepdim=True).clamp_min(tiny)
    prob, logc = prob / norm, torch.log(norm[:, 0])
    probs, logcs = [prob], [logc]
    for t in (range(t_len - 1, 0, -1) if reverse else range(1, t_len)):
        m_t = mask[:, t, None]
        raw = step(prob * e_llh[:, t]) if reverse else step(prob) * e_llh[:, t]
        norm = raw.sum(-1, keepdim=True).clamp_min(tiny)
        prob = m_t * (raw / norm) + (1 - m_t) * prob
        logc = m_t[:, 0] * (logc + torch.log(norm[:, 0])) + (1 - m_t[:, 0]) * logc
        probs.append(prob)
        logcs.append(logc)
    if reverse:
        probs.reverse()
        logcs.reverse()
    return torch.stack(probs, 1), torch.stack(logcs, 1)


def smoothing_loop(e_llh, mask, final, a_probs, step_t):
    """The v-space backward recursion with the smoothing outputs in-step,
    differentiable: (γ, ŵ, Σ e·β̂ (w_sums), Σ α̂·β̂ (post_norm)), each per
    frame.  ``step_t`` maps the carry v̂ (B, S) to A v̂."""
    b, t_len, _ = e_llh.shape
    tiny = torch.finfo(e_llh.dtype).tiny
    final = final.expand(b, -1)
    mask_next = torch.cat([mask[:, 1:], mask.new_zeros(b, 1)], dim=1)
    v_hat = final / final.sum(-1, keepdim=True).clamp_min(tiny)
    outs = []
    for t in range(t_len - 1, -1, -1):
        m_t, mn_t = mask[:, t, None], mask_next[:, t, None]
        is_last = m_t * (1.0 - mn_t)
        u1 = is_last * final + (1.0 - is_last) * step_t(v_hat)
        nu = u1.sum(-1, keepdim=True).clamp_min(tiny)
        ab = a_probs[:, t] * (u1 / nu)
        pn = ab.sum(-1, keepdim=True)
        gamma = (ab / pn.clamp_min(tiny)) * m_t
        v = e_llh[:, t] * u1
        sv = v.sum(-1, keepdim=True).clamp_min(tiny)
        w = v / sv
        v_hat = m_t * w + (1.0 - m_t) * v_hat
        outs.append((gamma, w, (sv / nu)[:, 0], pn[:, 0]))
    gamma, w, wsum, pnorm = (torch.stack(x[::-1], 1) for x in zip(*outs))
    return gamma, w, wsum, pnorm


def _general_steps(trans, banded: bool):
    """(p ↦ pA, v ↦ Av) for a dense (S, S) matrix or ``bands`` (4, S)."""
    if banded:
        return _band_propagators(trans)
    return (lambda p: p @ trans), (lambda v: v @ trans.T)


def _check_general(name, banded, e_llh, lens, trans, vec, a_probs=None):
    """K12's and K13's operand checks; returns (B, T, S)."""
    b, t_len, s = e_llh.shape
    operands = dict(e_llh=e_llh, lens=lens, trans=trans, vec=vec)
    shapes = [("lens", lens, (b,)), ("trans", trans, (4, s) if banded else (s, s)),
              ("vec", vec, (b, s))]
    if a_probs is not None:
        operands["a_probs"] = a_probs
        shapes.append(("a_probs", a_probs, (b, t_len, s)))
    _check(operands, e_llh.device, dict(lens=torch.int32))
    for label, x, shape in shapes:
        _shape(f"{name}: {label}", x, shape)
    return b, t_len, s


def scaled_pass_plain(e_llh, lens, trans, vec, banded=False, reverse=False):
    """Plain version of :func:`scaled_pass` (any dtype and device)."""
    forward, backward = _general_steps(trans, banded)
    return scaled_loop(e_llh, _prefix_mask(lens, e_llh.shape[1], e_llh), vec,
                       backward if reverse else forward, reverse)


@scoped("beer.kernel.scaled_pass")
def scaled_pass(e_llh, lens, trans, vec, banded=False, reverse=False):
    """Scaled recursion of the general path over precomputed likelihoods.

    ``e_llh`` (B, T, S) = exp(llh − rowmax), 1 on frames t >= len;
    ``trans`` a dense (S, S) matrix, or with ``banded`` the ``bands``
    (4, S); ``vec`` (B, S) the initial (forward) or final (``reverse``)
    vector.  Returns ``probs`` (B, T, S) normalised carries and ``logcs``
    (B, T) cumulative log-scales; log Z = logcs[:, −1] + Σ shifts +
    log Σ probs[:, −1]·final for the forward.

    Forward: frame 0 fires on every row (an empty row carries
    normalise(vec)) and frames t >= max(len, 1) repeat the last valid
    (probs, logcs).  Reverse: β̂, whose carry starts at vec / Σvec with
    log-scale log Σvec and is stored on frames t >= len − 1.  The three
    instances of K12 are dense forward, banded forward (in chunks,
    :func:`scaled_banded_geometry`) and dense reverse (a group of
    utterances a block, :func:`dense_grouped_geometry`, rows taken in
    :func:`group_order`); a banded reverse raises.
    """
    refuse_grad("scaled_pass", e_llh, trans, vec)
    if banded and reverse:
        raise NotImplementedError("scaled_pass has no banded reverse instance")
    if e_llh.device.type == "cpu":
        return scaled_pass_plain(e_llh, lens, trans, vec, banded, reverse)
    b, t_len, s = _check_general("scaled_pass", banded, e_llh, lens, trans, vec)
    dev = e_llh.device
    mode = 2 if reverse else int(banded)
    lib = _library()
    if banded:
        placement, n_utt, param = scaled_banded_geometry(s, b, sm_count(dev.index))
        order = None
    else:
        placement, n_utt, param = dense_grouped_geometry("scaled_pass", s, b, sm_count(dev.index))
        trans = _grouped_matrix(trans.T if reverse else trans)
        order = group_order(lens)
    glob = int(placement == "global")
    _fits(f"S={s}", lib.beer_scaled_pass_smem_bytes(mode, s, glob, n_utt, param))
    probs = torch.empty(b, t_len, s, device=dev)
    logcs = torch.empty(b, t_len, device=dev)
    _launch(lib.beer_scaled_pass, dev.index, mode, glob, n_utt, param, _ptr(e_llh), _ptr(lens),
            None if order is None else _ptr(order), *map(_ptr, (trans, vec, probs, logcs)), b, t_len, s,
            _stream(dev))
    KERNELS["scaled_pass"].launches += 1
    return probs, logcs


def smoothing_pass_plain(e_llh, a_probs, lens, trans, final, banded=False):
    """Plain version of :func:`smoothing_pass` (any dtype and device)."""
    return smoothing_loop(e_llh, _prefix_mask(lens, e_llh.shape[1], e_llh), final, a_probs,
                          _general_steps(trans, banded)[1])


@scoped("beer.kernel.smoothing_pass")
def smoothing_pass(e_llh, a_probs, lens, trans, final, banded=False):
    """v-space backward of the general path with the smoothing outputs
    in-step, over ``e_llh`` and the forward's ``a_probs`` (both (B, T, S)).

    ``trans`` is a dense (S, S) matrix, or with ``banded`` the ``bands``
    (4, S); ``final`` (B, S).  Returns the posteriors ``gamma`` (B, T, S),
    ``w_probs`` (B, T, S) = normalise(e·β̂), ``w_sums`` (B, T) = Σ e·β̂ and
    ``post_norm`` (B, T) = Σ α̂·β̂, the by-products the ξ counts are rebuilt
    from.  ``gamma`` is 0 on frames t >= len.  The other three are
    compared and read on valid frames only: there the kernel writes
    w_probs = 0 and w_sums = post_norm = 1, the plain version what the
    recursion drifts to.
    """
    refuse_grad("smoothing_pass", e_llh, a_probs, trans, final)
    if e_llh.device.type == "cpu":
        return smoothing_pass_plain(e_llh, a_probs, lens, trans, final, banded)
    b, t_len, s = _check_general("smoothing_pass", banded, e_llh, lens, trans, final, a_probs)
    dev = e_llh.device
    lib = _library()
    if banded:
        placement, n_utt, chunk = smoothing_banded_geometry(s, b, sm_count(dev.index))
        glob = int(placement == "global")
        _fits(f"S={s}", lib.beer_smoothing_banded_smem_bytes(s, glob, n_utt, chunk))
    else:
        placement, n_utt, ks = dense_grouped_geometry("smoothing_pass", s, b, sm_count(dev.index))
        glob = int(placement == "global")
        _fits(f"S={s}", lib.beer_smoothing_smem_bytes(s, glob, n_utt, ks))
        trans = _grouped_matrix(trans.T)
        order = group_order(lens)
    gamma = torch.empty(b, t_len, s, device=dev)
    w_probs = torch.empty(b, t_len, s, device=dev)
    w_sums = torch.empty(b, t_len, device=dev)
    post_norm = torch.empty(b, t_len, device=dev)
    outs = *map(_ptr, (trans, final, gamma, w_probs, w_sums, post_norm)), b, t_len, s, _stream(dev)
    if banded:
        _launch(lib.beer_smoothing_banded, dev.index, glob, n_utt, chunk, _ptr(e_llh), _ptr(a_probs), _ptr(lens),
                *outs)
    else:
        _launch(lib.beer_smoothing_pass, dev.index, glob, n_utt, ks, _ptr(e_llh), _ptr(a_probs), _ptr(lens),
                _ptr(order), *outs)
    KERNELS["smoothing_pass"].launches += 1
    return gamma, w_probs, w_sums, post_norm
