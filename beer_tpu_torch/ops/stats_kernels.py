"""Full-covariance statistics kernels: wrappers, plain versions, packing.

Counterpart of ``beer_tpu/ops/stats_kernels.py`` (B5, B6).  Three
hand-written CUDA kernels (``csrc/stats_full.cu``) keep the per-frame
full-covariance statistic out of device memory: each builds
S(x) = [x_i·x_j (i ≤ j), x, 1] (L = D(D+1)/2 + D + 1 lanes, the upper
triangle of xxᵀ) in shared memory a tile of frames at a time, as exact
float32 products, and contracts it there:

* :func:`gmm_estep_full` (K8) — the whole GMM E-step: the joint
  log-density S·W, the per-frame log-marginal and the responsibilities
  (which never leave the chip), and Σ_t r_t ⊗ S(x_t);
* :func:`ellh_full` (K9) — the (T, K) expected log-likelihood S·W;
* :func:`accumulate_full` (K10) — Σ_t r_t ⊗ S(x_t) for given
  responsibilities.

Host-side packing: the weight matrix W (L, K) holds −½E[Λ] on the upper
triangle (off-diagonal terms doubled), then E[Λμ], then the constant (plus
E[log w] for K8); the kernels' (K, L) sums are gathered back to the
(K, D²+D+2) NormalWishart layout by the exact index
:func:`ut_unpack_index`.  The JAX package's bf16 three-limb split and
its 0/1 selector matmuls are a workaround for the TPU's lane broadcast
and have no counterpart here.

Each wrapper refuses an input that requires grad while grad mode is on
(its outputs carry no gradient; see :func:`cuda_scan.refuse_grad`), runs
its plain PyTorch version (written like the JAX package's ``*_xla``
functions) on a CPU tensor, and on a CUDA tensor checks its operands,
launches the kernel on the current stream, counts the launch in
:data:`beer_tpu_torch.ops.cuda_scan.KERNELS`, or raises; it never falls
back to the plain version.  Each call runs inside the span
``beer.kernel.<name>``, as the scan kernels' do.  :class:`EllhFull` is
K9 with a gradient with respect to the frames: the route the structured
VAE's full-covariance priors take.  The kernels take D <=
:data:`MAX_DIM`; K8 and K10 hold a tile's K responsibilities in shared
memory and take K <= :data:`MAX_COMP`.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from beer_tpu_torch.dists.normallik import suff_stats_full
from beer_tpu_torch.ops import cuda_scan
from beer_tpu_torch.utils.profiling import scoped

LOG_2PI = math.log(2.0 * math.pi)
MAX_DIM = 128
MAX_COMP = 256
# the kernel selector of beer_stats_smem_bytes / beer_stats_blocks
_KIND = {"gmm_estep_full": 0, "ellh_full": 1, "accumulate_full": 2}


# ----------------------------------------------------------------------
# Packing
# ----------------------------------------------------------------------
@functools.cache
def ut_pairs(d: int) -> np.ndarray:
    """(D(D+1)/2, 2) upper-triangular pairs (i, j), i <= j, row by row:
    the lane order of the packed statistic."""
    return np.array([(i, j) for i in range(d) for j in range(i, d)], np.int64).reshape(-1, 2)


@functools.cache
def ut_unpack_index(d: int) -> np.ndarray:
    """(D²,) index into the packed lanes that rebuilds the full xxᵀ."""
    pos = {}
    for lane, (i, j) in enumerate(ut_pairs(d)):
        pos[(i, j)] = pos[(j, i)] = lane
    return np.array([pos[(i, j)] for i in range(d) for j in range(d)], np.int64)


def packed_width(d: int) -> int:
    """L = D(D+1)/2 + D + 1."""
    return d * (d + 1) // 2 + d + 1


@functools.cache
def _indices(d: int, device: torch.device):
    """The packing's index tensors on ``device``, made once per (D,
    device) so that a wrapper call copies nothing from the host: the
    pairs' rows ``i`` and columns ``j``, the flat index i·D + j into
    vec(E[Λ]), the factor (1 on the diagonal, 2 off it) and
    :func:`ut_unpack_index`."""
    i, j = torch.as_tensor(ut_pairs(d), device=device).T
    factor = torch.where(i == j, 1.0, 2.0)
    return i, j, i * d + j, factor, torch.as_tensor(ut_unpack_index(d), device=device)


def packed_stats(x: torch.Tensor) -> torch.Tensor:
    """The packed statistic S(x) = [x_i·x_j (i <= j), x, 1], (T, L): what
    the kernels build in shared memory, materialised (tests and the
    on-card yardstick only)."""
    i, j = _indices(x.shape[-1], x.device)[:2]
    return torch.cat([x[:, i] * x[:, j], x, x.new_ones(x.shape[0], 1)], dim=1)


def pack_weights(e_stats: torch.Tensor, dim: int, log_w=None) -> torch.Tensor:
    """W (L, K) with S(x)·W = the expected log-likelihood of every
    component (+ ``log_w``): −½E[Λ] on the upper triangle with the
    off-diagonal terms doubled, E[Λμ], and the constant
    −½E[μᵀΛμ] + ½E[log|Λ|] − (D/2) log 2π (+ E[log w])."""
    d = dim
    _, _, flat, factor, _ = _indices(d, e_stats.device)
    quad = -0.5 * e_stats[:, flat] * factor.to(e_stats.dtype)
    const = -0.5 * e_stats[:, -2] + 0.5 * e_stats[:, -1] - 0.5 * d * LOG_2PI
    if log_w is not None:
        const = const + log_w
    return torch.cat([quad, e_stats[:, d * d : d * d + d], const[:, None]], dim=1).T.contiguous()


def unpack_acc(acc_s: torch.Tensor, dim: int):
    """(K, L) packed sums Σ r ⊗ S(x) → (acc (K, D²+D+2) in the
    NormalWishart natural layout, counts (K,))."""
    d = dim
    n_ut = d * (d + 1) // 2
    acc_xx = acc_s[:, _indices(d, acc_s.device)[4]]
    counts = acc_s[:, n_ut + d]
    c = counts[:, None]
    return torch.cat([-0.5 * acc_xx, acc_s[:, n_ut : n_ut + d], -0.5 * c, 0.5 * c], dim=1), counts


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------
def ellh_full_plain(x: torch.Tensor, e_stats: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`ellh_full` (any dtype and device)."""
    d = x.shape[-1]
    elam = e_stats[:, : d * d].reshape(-1, d, d)
    elin = e_stats[:, d * d : d * d + d]
    const = -0.5 * e_stats[:, -2] + 0.5 * e_stats[:, -1] - 0.5 * d * LOG_2PI
    quad = torch.einsum("td,kde,te->tk", x, elam, x)
    return -0.5 * quad + x @ elin.T + const


def accumulate_full_plain(x: torch.Tensor, resps: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`accumulate_full`: materialises the (T,
    D²+D+2) statistics."""
    return resps.T @ suff_stats_full(x)


def gmm_estep_full_plain(x, e_stats, log_w, mask=None):
    """Plain version of :func:`gmm_estep_full` (any dtype and device)."""
    joint = ellh_full_plain(x, e_stats) + log_w
    llh = torch.logsumexp(joint, dim=-1)
    r = torch.exp(joint - llh[:, None])
    if mask is not None:
        m = mask.reshape(-1).to(llh.dtype)
        llh = llh * m
        r = r * m[:, None]
    return llh, accumulate_full_plain(x, r), r.sum(0)


# ----------------------------------------------------------------------
# Wrappers
# ----------------------------------------------------------------------
# ----------------------------------------------------------------------
# Launch geometry
# ----------------------------------------------------------------------
ELLH_LANE_CHUNK = 16        # K9: lanes a chunk of its ring
ELLH_FULL_GRID = 4 * 132    # K9 takes 128-frame tiles from this many blocks up
ACC_LANES = 128             # K10: lanes a block
ACC_FRAMES = 32             # K10: frames a tile


def ellh_tiles(t_len: int, k: int):
    """K9's (frame tile, component tile): the component tile is the
    smallest of 16, 32, 64 that holds K, else 128; the frame tile is 128
    when that gives at least :data:`ELLH_FULL_GRID` blocks (four waves of
    the H100's 132 SMs), else 64, so that a short input still fills the
    card."""
    tile_k = next((c for c in (16, 32, 64) if k <= c), 128)
    n_k = -(-k // tile_k)
    tile_t = 128 if -(-t_len // 128) * n_k >= ELLH_FULL_GRID else 64
    return tile_t, tile_k


def accumulate_tile_k(k: int) -> int:
    """K10's component tile: 32 for K <= 32, else 64."""
    return 32 if k <= 32 else 64


def accumulate_tiles(t_len: int, d: int, k: int, resident: int):
    """K10's (component tile, frame slices, frames a slice): as many
    slices as fill the card's ``resident`` blocks beside the (component
    tile × 128-lane) output tiles, each a whole number of 32-frame tiles,
    none empty."""
    tile_k = accumulate_tile_k(k)
    n_out = -(-packed_width(d) // ACC_LANES) * -(-k // tile_k)
    n_tiles = -(-t_len // ACC_FRAMES)
    if n_tiles == 0:
        return tile_k, 0, ACC_FRAMES
    per = -(-n_tiles // min(n_tiles, max(1, round(resident / n_out))))
    return tile_k, -(-n_tiles // per), per * ACC_FRAMES


ESTEP_LANE_CHUNK = 16       # K8: lanes a chunk of its joint's ring
ESTEP_TILE_OUTPUTS = 8192   # K8: a joint tile's frames × components (256 threads × 8 × 4)
ESTEP_TWO_BLOCKS = 116224   # shared memory that lets two K8 blocks share an SM


def estep_k_pad(k: int, tile_k: int) -> int:
    """K8's padded component count: a whole number of joint tiles and of
    accumulation tiles (32 components for K <= 32, else 64)."""
    step = max(tile_k, accumulate_tile_k(k))
    return -(-k // step) * step


def estep_smem_bytes(d: int, k: int, tile_k: int, frames: int) -> int:
    """Shared memory of one K8 block (``csrc/stats_full.cu`` EstepLayout):
    the supertile's frames as x̃ = [x, 1, 0], its mask, the lane table,
    its joint and responsibilities (frames, K_pad + 4), and the larger of
    the joint's ring and the accumulation's two S tiles."""
    r4 = lambda n: -(-n // 4) * 4  # noqa: E731
    width = packed_width(d)
    table = max((-(-width // ESTEP_LANE_CHUNK) + 1) * ESTEP_LANE_CHUNK,
                -(-width // ACC_LANES) * ACC_LANES)
    ring = 2 * (ESTEP_LANE_CHUNK * (ESTEP_TILE_OUTPUTS // tile_k + 4) + ESTEP_LANE_CHUNK * tile_k)
    acc = 2 * ACC_FRAMES * (ACC_LANES + 4)
    floats = (r4(frames * ((d + 2) | 1)) + r4(frames) + r4((table + 1) // 2)
              + frames * (estep_k_pad(k, tile_k) + 4) + max(ring, acc))
    return 4 * floats


def estep_tiles(d: int, k: int):
    """K8's (joint component tile, frames a supertile): the component
    tile is the smallest of 32, 64 that holds K, else 128, and a joint
    tile covers 8192 / tile_k frames; a supertile is the largest whole
    number of joint tiles up to 256 frames whose block leaves room for a
    second on the SM, else one joint tile."""
    tile_k = next((c for c in (32, 64) if k <= c), 128)
    tile_t = ESTEP_TILE_OUTPUTS // tile_k
    for frames in range(256, tile_t - 1, -tile_t):
        if estep_smem_bytes(d, k, tile_k, frames) <= ESTEP_TWO_BLOCKS:
            return tile_k, frames
    return tile_k, tile_t


@functools.cache
def _ready(device: int) -> None:
    """Once per device: the kernels may take the shared memory they need."""
    cuda_scan._launch(cuda_scan._library().beer_stats_prepare, device)


@functools.cache
def _resident(device: int, name: str, d: int, k: int, tile_t: int, tile_k: int) -> int:
    """Resident blocks of K8 (at D, K and its tiles) or of K10's instance
    on the card (blocks per SM × SMs), queried once per (device, kernel,
    D, K, tiles)."""
    _ready(device)
    n = cuda_scan._library().beer_stats_blocks(device, _KIND[name], d, k, tile_t, tile_k)
    if n < 0:
        raise RuntimeError(f"{name}: occupancy query failed: "
                           f"{cuda_scan._library().beer_error_string(-n).decode()}")
    return n


def _prepare(name: str, x: torch.Tensor, k: int, operands: dict, shapes: list, tile_t=0, tile_k=0):
    """Checks of every wrapper: device, float32, contiguity, shapes, the
    kernel's D and K limits and its shared memory.  Returns the library."""
    t_len, d = x.shape
    cuda_scan._check(dict(x=x, **operands), x.device, {})
    for arg, tensor, shape in shapes:
        cuda_scan._shape(arg, tensor, shape)
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"{name}: D={d}; the kernel takes 1 <= D <= {MAX_DIM}")
    if k < 1 or (name != "ellh_full" and k > MAX_COMP):
        raise ValueError(f"{name}: K={k}; the kernel holds a tile's responsibilities in shared "
                         f"memory and takes 1 <= K <= {MAX_COMP}")
    lib = cuda_scan._library()
    cuda_scan._fits(f"{name} at D={d}, K={k}",
                    lib.beer_stats_smem_bytes(_KIND[name], d, k, tile_t, tile_k))
    _ready(x.device.index)
    return lib


def _run(name: str, launch) -> None:
    """Launch a prepared kernel call; raise if the launch was refused."""
    code = launch()
    if code != 0:
        raise RuntimeError(f"CUDA kernel launch failed: "
                           f"{cuda_scan._library().beer_error_string(code).decode()}")
    cuda_scan.KERNELS[name].launches += 1


def prepare_gmm_estep_full(x, e_stats, log_w, mask=None):
    """K8's checks, packing and launch geometry: returns (llh, out, launch),
    where ``launch()`` is the bare foreign call filling ``llh`` (T,) and
    ``out`` (K, L) and returning its CUDA error code."""
    t_len, d = x.shape
    k = e_stats.shape[0]
    dev = x.device
    tile_k, frames = estep_tiles(d, k)
    operands = dict(e_stats=e_stats, log_w=log_w)
    shapes = [("e_stats", e_stats, (k, d * d + d + 2)), ("log_w", log_w, (k,))]
    if mask is not None:
        mask = mask.reshape(-1)
        operands["mask"] = mask
        shapes.append(("mask", mask, (t_len,)))
    lib = _prepare("gmm_estep_full", x, k, operands, shapes, frames, tile_k)
    width = packed_width(d)
    k_pad = estep_k_pad(k, tile_k)
    chunks = -(-width // ESTEP_LANE_CHUNK) + 1     # and one chunk of zeros past the last
    w = torch.nn.functional.pad(pack_weights(e_stats, d, log_w),
                                (0, k_pad - k, 0, chunks * ESTEP_LANE_CHUNK - width))
    lanes = -(-width // ACC_LANES) * ACC_LANES
    resident = _resident(dev.index, "gmm_estep_full", d, k, frames, tile_k)
    n_blk = min(resident, -(-t_len // frames))
    part = torch.empty(n_blk, k * lanes, device=dev)
    out = torch.empty(k * lanes, device=dev)
    llh = torch.empty(t_len, device=dev)
    ptr = cuda_scan._ptr
    launch = functools.partial(lib.beer_gmm_estep_full, dev.index, ptr(x),
                               None if mask is None else ptr(mask), ptr(w), ptr(llh), ptr(part),
                               ptr(out), n_blk, t_len, d, k, frames, tile_k, cuda_scan._stream(dev))
    launch.keep = (x, mask, w, llh, part, out)   # every operand outlives the call
    return llh, out.view(k, lanes)[:, :width], launch


@scoped("beer.kernel.gmm_estep_full")
def gmm_estep_full(x, e_stats, log_w, mask=None):
    """One-kernel GMM E-step (K8): (T, D) frames → per-frame log-marginal
    ``llh`` (T,), ``acc`` (K, D²+D+2) = Σ_t r_t ⊗ s(x_t) in the
    NormalWishart natural layout and ``counts`` (K,) = Σ_t r_t, where r_t
    = softmax_k(ellh_k(x_t) + log_w) · mask_t.  ``mask`` (T,) or None."""
    cuda_scan.refuse_grad("gmm_estep_full", x, e_stats, log_w)
    if x.device.type == "cpu":
        return gmm_estep_full_plain(x, e_stats, log_w, mask)
    llh, out, launch = prepare_gmm_estep_full(x, e_stats, log_w, mask)
    _run("gmm_estep_full", launch)
    acc, counts = unpack_acc(out, x.shape[1])
    return llh, acc, counts


def prepare_ellh_full(x, e_stats):
    """K9's checks, packing and launch geometry: returns (out, launch).
    W (L, K) is zero-padded to whole lane chunks (and one more) and whole
    component tiles."""
    t_len, d = x.shape
    k = e_stats.shape[0]
    dev = x.device
    tile_t, tile_k = ellh_tiles(t_len, k)
    lib = _prepare("ellh_full", x, k, dict(e_stats=e_stats),
                   [("e_stats", e_stats, (k, d * d + d + 2))], tile_t, tile_k)
    width = packed_width(d)
    k_pad = -(-k // tile_k) * tile_k
    chunks = -(-width // ELLH_LANE_CHUNK) + 1      # and one chunk of zeros past the last
    w = torch.nn.functional.pad(pack_weights(e_stats, d),
                                (0, k_pad - k, 0, chunks * ELLH_LANE_CHUNK - width))
    out = torch.empty(t_len, k, device=dev)
    ptr = cuda_scan._ptr
    launch = functools.partial(lib.beer_ellh_full, dev.index, ptr(x), ptr(w), ptr(out), t_len, d,
                               k, k_pad, tile_t, tile_k, cuda_scan._stream(dev))
    launch.keep = (x, w, out)
    return out, launch


@scoped("beer.kernel.ellh_full")
def ellh_full(x, e_stats):
    """Expected log-likelihood of K full-covariance components (K9): (T,
    D) frames × (K, D²+D+2) E[T] → (T, K)."""
    cuda_scan.refuse_grad("ellh_full", x, e_stats)
    if x.device.type == "cpu":
        return ellh_full_plain(x, e_stats)
    out, launch = prepare_ellh_full(x, e_stats)
    _run("ellh_full", launch)
    return out


def prepare_accumulate_full(x, resps):
    """K10's checks and launch geometry: returns (out (K, L), launch)."""
    t_len, d = x.shape
    k = resps.shape[-1]
    dev = x.device
    tile_k = accumulate_tile_k(k)
    lib = _prepare("accumulate_full", x, k, dict(resps=resps), [("resps", resps, (t_len, k))],
                   tile_k=tile_k)
    # the kernel copies frames and responsibilities 16 bytes at a time
    x, resps = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, resps))
    resident = _resident(dev.index, "accumulate_full", d, k, 0, tile_k)
    _, n_slices, slice_len = accumulate_tiles(t_len, d, k, resident)
    width = packed_width(d)
    lanes = -(-width // ACC_LANES) * ACC_LANES
    part = torch.empty(n_slices, k * lanes, device=dev)
    out = torch.empty(k * lanes, device=dev)
    ptr = cuda_scan._ptr
    launch = functools.partial(lib.beer_accumulate_full, dev.index, ptr(x), ptr(resps), ptr(part),
                               ptr(out), n_slices, slice_len, t_len, d, k, tile_k,
                               cuda_scan._stream(dev))
    launch.keep = (x, resps, part, out)
    return out.view(k, lanes)[:, :width], launch


@scoped("beer.kernel.accumulate_full")
def accumulate_full(x, resps):
    """Responsibility-weighted full-covariance statistics (K10): (T, D)
    frames × (T, K) responsibilities → (K, D²+D+2) = Σ_t r_t ⊗ s(x_t)."""
    cuda_scan.refuse_grad("accumulate_full", x, resps)
    if x.device.type == "cpu":
        return accumulate_full_plain(x, resps)
    out, launch = prepare_accumulate_full(x, resps)
    _run("accumulate_full", launch)
    return unpack_acc(out, x.shape[1])[0]


# ----------------------------------------------------------------------
# The differentiable ELLH
# ----------------------------------------------------------------------
class EllhFull(torch.autograd.Function):
    """K9 (or its plain version, ``plain=True``) with the closed-form
    gradient with respect to the frames: ellh_k(x) = −½xᵀE[Λ_k]x +
    xᵀE[Λ_k μ_k] + c_k, so ∂/∂x = Σ_k ct_k (E[Λ_k μ_k] − ½(E[Λ_k] +
    E[Λ_k]ᵀ) x), in plain torch products.  ``e_stats`` gets no gradient
    (the latent model is trained by its conjugate update) and is refused
    when it requires one.

    ``EllhFull.apply(x (T, D), e_stats (K, D²+D+2), plain) -> (T, K)``.
    """

    @staticmethod
    def forward(ctx, x, e_stats, plain=False):
        if e_stats.requires_grad:
            raise RuntimeError("EllhFull: e_stats gets no gradient (conjugate-trained)")
        ctx.save_for_backward(x, e_stats)
        return (ellh_full_plain if plain else ellh_full)(x, e_stats)

    @staticmethod
    def backward(ctx, ct):
        x, e_stats = ctx.saved_tensors
        d = x.shape[-1]
        elam = e_stats[:, : d * d].reshape(-1, d, d)
        elin = e_stats[:, d * d : d * d + d]
        quad = torch.einsum("tk,kde,te->td", ct, elam + elam.transpose(-1, -2), x)
        return ct @ elin - 0.5 * quad, None, None
