"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda`` and skipped where torch sees no CUDA device: a CUDA
kernel has no CPU mode.  The machine with the card has no JAX, and
``tests/conftest.py`` imports it, so run this file there without the
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances (float32; the kernels and the plain versions sum in
different orders): log Z rel 1e-5, α̂, γ and γ0 abs 1e-5, the reduced
statistics and ξ rel 1e-4 of their largest entry; the Viterbi kernels
do the same float adds and maxima as their plain versions, so their
outputs are equal.  The full-covariance kernels (K8–K10): the ELLH and
the per-frame log-marginals rel 1e-5 of their largest magnitude, the
statistics and counts rel 1e-4 (sum order, as above).  K11 (the
γ-emitting banded backward): γ and γ0 abs 1e-5, ξ rel 1e-4; the
differentiable routes (``PhoneLoopLogZ``, ``HMMLogZ``, ``EllhFull``):
log Z rel 1e-5 and gradients rel 1e-4 of the plain route's.  The dense
kernels are held on both sides of their shared-memory limit (the
global placement above it), at the same gates.
"""

import copy
import inspect
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import beer_tpu_torch as bt
from beer_tpu_torch.ops import cuda_scan
from beer_tpu_torch.ops import semiring_scan as tss
from beer_tpu_torch.ops import stats_kernels as sk
from port_util import dense_args, dense_problem, full_problem, port_args, scan_problem, t, underflow_problem

pytestmark = pytest.mark.cuda

# (units, states per unit, P, B, T): tiny; the bench's S=150, P=78; and
# S > 1024 states (threads stride over states)
SHAPES = [(3, 2, 4, 5, 17), (50, 3, 78, 6, 60), (100, 11, 6, 3, 9)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "S%d_P%d" % (s[0] * s[1], s[2]))
def test_kernels_match_plain_versions(device, shape):
    u, spu, p_dim, b, t_len = shape
    a = port_args(scan_problem(0, u, spu, p_dim, b, t_len), torch.float32, device)
    full = a["lens"] > 0
    cuda_scan.reset_launch_counts()

    fwd = (a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["init"])
    alpha, norms, last, logz = cuda_scan.forward_llh_banded(*fwd)
    ref = cuda_scan.forward_llh_banded_plain(*fwd)
    torch.cuda.synchronize()
    tiny = torch.finfo(torch.float32).tiny  # rows too short to reach an end state
    log_z = logz + torch.log((last * a["final"]).sum(-1).clamp_min(tiny))
    log_z_ref = ref[3] + torch.log((ref[2] * a["final"]).sum(-1).clamp_min(tiny))
    assert _rel(log_z[full], log_z_ref[full]) <= 1e-5
    assert float((alpha - ref[0]).abs().max()) <= 1e-5
    assert float((norms - ref[1]).abs().max() / ref[1].abs().max()) <= 1e-5

    est = (a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["final"], alpha, norms,
           a["ends"], a["starts"])
    got = cuda_scan.estep_acc_banded(*est)
    want = cuda_scan.estep_acc_banded_plain(*est)
    for name, x, y in zip(("acc2", "counts", "xi"), (got[0], got[1], got[3]),
                          (want[0], want[1], want[3])):
        assert _rel(x, y) <= 1e-4, name
    assert float((got[2] - want[2]).abs().max()) <= 1e-5
    gamma = cuda_scan.estep_gamma_banded(*est)
    want = cuda_scan.estep_gamma_banded_plain(*est)
    assert float((gamma[0] - want[0]).abs().max()) <= 1e-5
    assert float((gamma[1] - want[1]).abs().max()) <= 1e-5 and _rel(gamma[2], want[2]) <= 1e-4

    llh = (a["stats"] @ a["w"].T + a["bias"]).contiguous()
    lb, li, lf = (tss.log_bands(a[k]).contiguous() for k in ("bands", "init", "final"))
    ch, ex, al = cuda_scan.viterbi_fwd_banded(llh, a["lens"], lb, li)
    ch_r, ex_r, al_r = cuda_scan.viterbi_fwd_banded_plain(llh, a["lens"], lb, li)
    assert torch.equal(ch, ch_r) and torch.equal(ex, ex_r) and torch.equal(al, al_r)
    paths, scores = cuda_scan.viterbi_backtrace_banded(ch, ex, al, lf)
    paths_r, scores_r = cuda_scan.viterbi_backtrace_banded_plain(ch, ex, al, lf)
    assert torch.equal(paths, paths_r) and torch.equal(scores, scores_r)
    assert all(k.launches == 1 for name, k in cuda_scan.KERNELS.items() if name.endswith("_banded"))


def test_wrappers_reject_what_the_kernels_do_not_take(device):
    a = port_args(scan_problem(1, 3, 2, 4, 4, 9), torch.float32, device)
    args = [a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["init"]]
    with pytest.raises(TypeError):
        cuda_scan.forward_llh_banded(args[0].double(), *args[1:])
    with pytest.raises(TypeError):
        cuda_scan.forward_llh_banded(args[0], args[1].long(), *args[2:])
    with pytest.raises(ValueError):
        cuda_scan.forward_llh_banded(args[0].transpose(0, 1).contiguous().transpose(0, 1),
                                     *args[1:])
    with pytest.raises(ValueError):
        cuda_scan.forward_llh_banded(args[0], args[1].cpu(), *args[2:])
    with pytest.raises(ValueError):
        cuda_scan.forward_llh_banded(args[0], args[1], args[2][:-1], *args[3:])


def test_zero_length_rows_and_empty_batch(device):
    pb = scan_problem(2, 3, 2, 4, 3, 9, lengths=[0, 0, 0])
    a = port_args(pb, torch.float32, device)
    alpha, norms, last, logz = cuda_scan.forward_llh_banded(
        a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["init"])
    assert not alpha.any() and (norms == 1).all() and not logz.any()
    assert torch.equal(last, a["init"].expand(3, -1))
    acc2, counts, gamma0, xi = cuda_scan.estep_acc_banded(
        a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["final"], alpha, norms,
        a["ends"], a["starts"])
    assert not acc2.any() and not counts.any() and not gamma0.any() and not xi.any()
    empty = port_args(scan_problem(2, 3, 2, 4, 0, 9, lengths=np.zeros(0, int)),
                      torch.float32, device)
    out = cuda_scan.forward_llh_banded(empty["stats"], empty["lens"], empty["w"],
                                       empty["bias"], empty["bands"], empty["init"])
    assert out[0].shape == (0, 9, 6)


# (S, P, B, T) of the dense kernels: tiny; config 3 (S=18) and config 2
# (S=30, P=78); S not a multiple of 32; S=150 (K7 and a narrow K6 fit)
DENSE_SHAPES = [(7, 4, 5, 17), (18, 78, 6, 40), (30, 78, 6, 60), (45, 6, 5, 21), (150, 6, 4, 12)]


def _dense_run(a, plain: bool):
    fwd = cuda_scan.forward_llh_dense_plain if plain else cuda_scan.forward_llh_dense
    acc = cuda_scan.estep_acc_dense_plain if plain else cuda_scan.estep_acc_dense
    gam = cuda_scan.estep_gamma_dense_plain if plain else cuda_scan.estep_gamma_dense
    f_stats = fwd(a["stats"], a["lens"], a["trans"], a["init"], a["w"], a["bias"])
    f_llh = fwd(a["llh"], a["lens"], a["trans"], a["init"])
    return (f_stats, f_llh,
            acc(a["stats"], a["lens"], a["w"], a["bias"], a["trans"], a["final"], *f_stats[:2]),
            gam(a["llh"], a["lens"], a["trans"], a["final"], *f_llh[:2]))


@pytest.mark.parametrize("shape", DENSE_SHAPES, ids=lambda s: "S%d_P%d" % s[:2])
def test_dense_kernels_match_plain_versions(device, shape):
    s, p_dim, b, t_len = shape
    a = dense_args(dense_problem(0, s, p_dim, b, t_len), torch.float32, device)
    full = a["lens"] > 0
    cuda_scan.reset_launch_counts()
    got = _dense_run(a, plain=False)
    torch.cuda.synchronize()
    want = _dense_run(a, plain=True)
    tiny = torch.finfo(torch.float32).tiny
    for g, w in zip(got[:2], want[:2]):
        log_z = [o[3] + torch.log((o[2] * a["final"]).sum(-1).clamp_min(tiny)) for o in (g, w)]
        assert _rel(log_z[0][full], log_z[1][full]) <= 1e-5
        assert float((g[0] - w[0]).abs().max()) <= 1e-5
        assert float((g[1] - w[1]).abs().max() / w[1].abs().max()) <= 1e-5
        assert torch.equal(g[2][~full], a["init"][~full]) and not g[3][~full].any()
    for name, i in (("acc2", 0), ("counts", 1), ("xi", 3)):
        assert _rel(got[2][i], want[2][i]) <= 1e-4, name
    assert float((got[2][2] - want[2][2]).abs().max()) <= 1e-5
    assert float((got[3][0] - want[3][0]).abs().max()) <= 1e-5
    assert _rel(got[3][1], want[3][1]) <= 1e-4
    launches = {k: v.launches for k, v in cuda_scan.KERNELS.items() if v.launches}
    assert launches == {"forward_llh_dense": 2, "estep_acc_dense": 1, "estep_gamma_dense": 1}


def test_dense_wrappers_reject_what_the_kernels_do_not_take(device):
    a = dense_args(dense_problem(1, 6, 4, 4, 9), torch.float32, device)
    fwd = [a["llh"], a["lens"], a["trans"], a["init"]]
    with pytest.raises(TypeError):
        cuda_scan.forward_llh_dense(fwd[0].double(), *fwd[1:])
    with pytest.raises(TypeError):
        cuda_scan.forward_llh_dense(fwd[0], fwd[1].long(), *fwd[2:])
    with pytest.raises(ValueError):
        cuda_scan.forward_llh_dense(*fwd[:3], fwd[3][0])             # init must be (B, S)
    with pytest.raises(ValueError):
        cuda_scan.forward_llh_dense(*fwd[:2], fwd[2][:-1], fwd[3])   # trans (S−1, S)
    with pytest.raises(ValueError):
        cuda_scan.forward_llh_dense(fwd[0][..., :-1].contiguous(), *fwd[1:])
    alpha, norms, _, _ = cuda_scan.forward_llh_dense(*fwd)
    with pytest.raises(ValueError):
        cuda_scan.estep_gamma_dense(a["llh"], a["lens"], a["trans"], a["final"][0], alpha, norms)
    with pytest.raises(TypeError):
        cuda_scan.estep_acc_dense(a["stats"], a["lens"], a["w"], a["bias"], a["trans"].double(),
                                  a["final"], alpha, norms)
    with pytest.raises(ValueError):
        cuda_scan.estep_acc_dense(a["stats"], a["lens"], a["w"], a["bias"], a["trans"],
                                  a["final"], alpha, norms.cpu())
    # (S, S) operands that do not fit in shared memory take the global
    # placement instead of being refused: K6 at S = 150, P = 78 and K7 at
    # S = 200 against their plain versions
    big = dense_args(dense_problem(2, 150, 78, 2, 5), torch.float32, device)
    assert cuda_scan.dense_placement("estep_acc_dense", 150, 78) == "global"
    f_big = cuda_scan.forward_llh_dense(big["stats"], big["lens"], big["trans"], big["init"],
                                        big["w"], big["bias"])
    est = (big["stats"], big["lens"], big["w"], big["bias"], big["trans"], big["final"], *f_big[:2])
    got, want = cuda_scan.estep_acc_dense(*est), cuda_scan.estep_acc_dense_plain(*est)
    assert all(_rel(got[i], want[i]) <= 1e-4 for i in (0, 1, 3))
    huge = dense_args(dense_problem(3, 200, 2, 2, 5), torch.float32, device)
    assert cuda_scan.dense_placement("estep_gamma_dense", 200) == "global"
    f_huge = cuda_scan.forward_llh_dense(huge["llh"], huge["lens"], huge["trans"], huge["init"])
    est = (huge["llh"], huge["lens"], huge["trans"], huge["final"], *f_huge[:2])
    got, want = cuda_scan.estep_gamma_dense(*est), cuda_scan.estep_gamma_dense_plain(*est)
    assert float((got[0] - want[0]).abs().max()) <= 1e-5 and _rel(got[1], want[1]) <= 1e-4


def test_dense_zero_length_rows_and_empty_batch(device):
    a = dense_args(dense_problem(4, 6, 4, 3, 9, lengths=[0, 0, 0]), torch.float32, device)
    for plain in (False, True):
        f_stats, f_llh, acc, gam = _dense_run(a, plain)
        for alpha, norms, last, logz in (f_stats, f_llh):
            assert not alpha.any() and (norms == 1).all() and not logz.any()
            assert torch.equal(last, a["init"])
        assert not any(x.any() for x in acc) and not any(x.any() for x in gam)
    empty = dense_args(dense_problem(4, 6, 4, 0, 9, lengths=np.zeros(0, int)), torch.float32,
                       device)
    for plain in (False, True):
        f_stats, f_llh, acc, gam = _dense_run(empty, plain)
        assert f_stats[0].shape == (0, 9, 6) and gam[0].shape == (0, 9, 6)
        assert acc[0].shape == (6, 4) and not acc[3].any() and not gam[1].any()


# (D, K, T) of the full-covariance kernels: D ∈ {2, 5, 39}, K ∈ {1, 7, 64}
# (and 200, several passes over K), T ∈ {1, 129, 1000} (ragged tiles of 128)
FULL_SHAPES = [(2, 1, 1), (5, 7, 129), (39, 64, 1000), (39, 7, 1), (2, 64, 129), (5, 1, 1000),
               (39, 200, 300)]


def _full_args(shape, device):
    d, k, t_len = shape
    return {name: t(v, torch.float32).to(device)
            for name, v in full_problem(sum(shape), d, k, t_len).items()}


@pytest.mark.parametrize("shape", FULL_SHAPES, ids=lambda s: "D%d_K%d_T%d" % s)
def test_full_cov_kernels_match_plain_versions(device, shape):
    a = _full_args(shape, device)
    cuda_scan.reset_launch_counts()
    for mask in (None, a["mask"]):
        got = sk.gmm_estep_full(a["x"], a["e"], a["log_w"], mask)
        want = sk.gmm_estep_full_plain(a["x"], a["e"], a["log_w"], mask)
        torch.cuda.synchronize()
        assert _rel(got[0], want[0]) <= 1e-5
        assert _rel(got[1], want[1]) <= 1e-4 and _rel(got[2], want[2]) <= 1e-4
    again = sk.gmm_estep_full(a["x"], a["e"], a["log_w"], a["mask"])
    assert all(torch.equal(g, h) for g, h in zip(got, again))   # no atomics: bitwise repeatable
    assert _rel(sk.ellh_full(a["x"], a["e"]), sk.ellh_full_plain(a["x"], a["e"])) <= 1e-5
    assert _rel(sk.accumulate_full(a["x"], a["r"]), sk.accumulate_full_plain(a["x"], a["r"])) <= 1e-4
    launches = {k: v.launches for k, v in cuda_scan.KERNELS.items() if k.endswith("_full")}
    assert launches == {"gmm_estep_full": 3, "ellh_full": 1, "accumulate_full": 1}


@pytest.mark.parametrize("d", [1, 39, 128])
@pytest.mark.parametrize("k", [1, 4, 60, 64, 65, 256])
def test_ellh_and_accumulate_match_plain_versions(device, d, k):
    """K9 and K10 at every (component tile, frame tile) they choose: T = 0,
    1, 129 (a ragged last tile) and 38,400 (the recognizer's frames), the
    responsibilities off on a masked stretch; two K10 runs agree bitwise."""
    for t_len in (0, 1, 129, 38_400):
        a = _full_args((d, k, t_len), device)
        resps = (a["r"] * a["mask"][:, None]).contiguous()
        cuda_scan.reset_launch_counts()
        ellh = sk.ellh_full(a["x"], a["e"])
        acc = sk.accumulate_full(a["x"], resps)
        again = sk.accumulate_full(a["x"], resps)
        torch.cuda.synchronize()
        assert _launched() == {"ellh_full": 1, "accumulate_full": 2}
        assert ellh.shape == (t_len, k) and acc.shape == (k, d * d + d + 2)
        assert torch.equal(acc, again)
        if t_len == 0:
            assert not acc.any()
            continue
        assert _rel(ellh, sk.ellh_full_plain(a["x"], a["e"])) <= 1e-5, t_len
        assert _rel(acc, sk.accumulate_full_plain(a["x"], resps)) <= 1e-4, t_len


@pytest.mark.parametrize("d", [1, 39, 128])
@pytest.mark.parametrize("k", [1, 65, 256])
def test_gmm_estep_full_at_every_tile(device, d, k):
    """K8 at every joint component tile (32, 64 at FULL_SHAPES, 128) and
    the supertiles it chooses: T = 0, 1, 129 (ragged) and 1000 (several
    supertiles a block), frames off on a masked stretch (llh 0 there); two
    runs agree bitwise.  llh rel 1e-5 of the plain version; the statistics
    against float64 (see below)."""
    for t_len in (0, 1, 129, 1000):
        a = _full_args((d, k, t_len), device)
        cuda_scan.reset_launch_counts()
        got = sk.gmm_estep_full(a["x"], a["e"], a["log_w"], a["mask"])
        again = sk.gmm_estep_full(a["x"], a["e"], a["log_w"], a["mask"])
        torch.cuda.synchronize()
        assert _launched() == {"gmm_estep_full": 2}
        assert all(torch.equal(g, h) for g, h in zip(got, again))
        assert got[0].shape == (t_len,) and got[1].shape == (k, d * d + d + 2)
        if t_len == 0:
            assert not got[1].any() and not got[2].any()
            continue
        want = sk.gmm_estep_full_plain(a["x"], a["e"], a["log_w"], a["mask"])
        assert _rel(got[0], want[0]) <= 1e-5, t_len
        # the statistics against float64: at D = 128 and production magnitudes
        # the joint is ~1e3, a sum of 8,385 products, and float32's rounding
        # of it moves the responsibilities of near-tied components, so the
        # float32 plain version itself misses 1e-4 there (1.6e-4 at K = 256);
        # the kernel sums each joint in one FMA chain, and may not be further
        # from float64 than 8× the plain version (the bound the 3×TF32 probe
        # was held to), nor than 1e-4 where float32 gets that close
        exact = sk.gmm_estep_full_plain(*(a[n].double() for n in ("x", "e", "log_w", "mask")))
        for i in (1, 2):
            assert _rel(got[i].double(), exact[i]) <= max(1e-4, 8 * _rel(want[i].double(), exact[i])), t_len
        assert not got[0][a["mask"] == 0].any()


def test_full_cov_wrappers_reject_what_the_kernels_do_not_take(device):
    a = _full_args((5, 7, 129), device)
    x, e, log_w, r = a["x"], a["e"], a["log_w"], a["r"]
    with pytest.raises(TypeError):
        sk.gmm_estep_full(x.double(), e, log_w)
    with pytest.raises(ValueError):
        sk.gmm_estep_full(x, e, log_w, a["mask"].cpu())
    with pytest.raises(ValueError):
        sk.gmm_estep_full(x, e, log_w, a["mask"][:-1])
    with pytest.raises(ValueError):
        sk.ellh_full(x.T.contiguous().T, e)
    with pytest.raises(ValueError):
        sk.ellh_full(x, e[:, :-1].contiguous())
    with pytest.raises(ValueError):
        sk.accumulate_full(x, r[:-1].contiguous())
    # above the stated limits: D <= 128; K <= 256 for K8 and K10; shared memory
    big_d = _full_args((129, 1, 4), device)
    for fn, args in ((sk.gmm_estep_full, (big_d["x"], big_d["e"], big_d["log_w"])),
                     (sk.ellh_full, (big_d["x"], big_d["e"])),
                     (sk.accumulate_full, (big_d["x"], big_d["r"]))):
        with pytest.raises(ValueError, match="D=129"):
            fn(*args)
    big_k = _full_args((2, 257, 4), device)
    with pytest.raises(ValueError, match="K=257"):
        sk.gmm_estep_full(big_k["x"], big_k["e"], big_k["log_w"])
    with pytest.raises(ValueError, match="K=257"):
        sk.accumulate_full(big_k["x"], big_k["r"])
    sk.ellh_full(big_k["x"], big_k["e"])                        # K9 takes any K
    # the largest D and K of K8's limits fit one block (its supertile shrinks)
    wide = _full_args((128, 256, 4), device)
    got = sk.gmm_estep_full(wide["x"], wide["e"], wide["log_w"])
    want = sk.gmm_estep_full_plain(wide["x"], wide["e"], wide["log_w"])
    assert _rel(got[0], want[0]) <= 1e-5 and _rel(got[1], want[1]) <= 1e-4


def test_full_cov_kernels_empty_input(device):
    a = _full_args((5, 7, 129), device)
    x0, r0 = a["x"][:0], a["r"][:0]
    llh, acc, counts = sk.gmm_estep_full(x0, a["e"], a["log_w"])
    assert llh.shape == (0,) and not acc.any() and not counts.any()
    assert sk.ellh_full(x0, a["e"]).shape == (0, 7)
    assert not sk.accumulate_full(x0, r0).any()


# ----------------------------------------------------------------------
# The diagonal statistics [−½x², x]: diag_stats
# ----------------------------------------------------------------------
def _frames(shape, device, seed=0, dtype=torch.float32):
    """N(0, 9) frames with exact zeros, −0, tiny values whose squares are
    subnormal or flush to zero and large ones whose squares overflow."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = 3.0 * torch.randn(shape, generator=gen, device=device, dtype=dtype)
    flat = x.view(-1)
    flat[::11] *= 1e-21 if dtype == torch.float32 else 1e-170
    flat[3::13] = 1e20 if dtype == torch.float32 else 1e160
    flat[5::17] = 0.0
    flat[7::19] = -0.0
    return x


@pytest.mark.parametrize("n", [0, 1, 7, 1024 * 500])
@pytest.mark.parametrize("d", [1, 3, 39, 40, 64])
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_diag_stats_equals_plain_version(device, n, d, ndim, dtype):
    """The kernel's statistics equal ``torch.cat([−½x², x], −1)`` to the bit
    (torch.equal), in a fresh contiguous (..., 2D) tensor of the frames'
    dtype, from (N, D) frames and from the same frames as (B, T, D)
    (N = 1,024 × 500); one launch, none for no frames."""
    shape = (n, d) if ndim == 2 else ((1024, 500, d) if n == 1024 * 500 else (1, n, d))
    x = _frames(shape, device, seed=n + d, dtype=dtype)
    cuda_scan.reset_launch_counts()
    got = sk.diag_stats(x)
    torch.cuda.synchronize()
    assert _launched() == ({"diag_stats": 1} if n else {})
    assert got.shape == (*shape[:-1], 2 * d) and got.is_contiguous() and got.dtype == dtype
    assert torch.equal(got, sk.diag_stats_plain(x))


def test_diag_stats_through_normal_set_takes_any_layout(device):
    """``NormalSet.sufficient_statistics`` on frames that are not contiguous
    (a transpose) or whose start is not 16-byte aligned, and float64 frames
    of a float64 set: one launch each, the plain expression's bits; with
    ``plain_scan`` the plain expression itself, and no launch."""
    nset = bt.NormalSet.create(torch.zeros(39, device=device), torch.ones(39, device=device), size=4)
    base = _frames((500, 8, 39), device)
    for x in (base.transpose(0, 1), base.reshape(-1, 39)[1:]):
        assert not x.is_contiguous() or x.data_ptr() % 16
        cuda_scan.reset_launch_counts()
        got = nset.sufficient_statistics(x)
        assert _launched() == {"diag_stats": 1}
        assert torch.equal(got, sk.diag_stats_plain(x))
    nset64 = bt.NormalSet.create(torch.zeros(39, device=device, dtype=torch.float64),
                                 torch.ones(39, device=device, dtype=torch.float64), size=4)
    x = _frames((500, 8, 39), device, dtype=torch.float64).transpose(0, 1)
    cuda_scan.reset_launch_counts()
    assert torch.equal(nset64.sufficient_statistics(x), sk.diag_stats_plain(x))
    assert _launched() == {"diag_stats": 1}
    nset.plain_scan = True
    cuda_scan.reset_launch_counts()
    assert torch.equal(nset.sufficient_statistics(base), sk.diag_stats_plain(base))
    assert _launched() == {}


def test_diag_stats_rejects_what_the_kernel_does_not_take(device):
    x = _frames((5, 39), device)
    with pytest.raises(TypeError):
        sk.diag_stats(x.half())
    with pytest.raises(RuntimeError, match="requires grad"):
        sk.diag_stats(x.clone().requires_grad_())
    with pytest.raises(ValueError):
        sk.diag_stats(x.T)
    with pytest.raises(ValueError):
        sk.diag_stats(_frames((2, sk.MAX_DIAG_DIM + 1), device))
    with pytest.raises(ValueError):
        sk.diag_stats(x.expand(2, 5, 39))


@pytest.mark.parametrize("model", ["phone_loop", "hmm"])
def test_diag_stats_launch_once_a_step_and_a_decode(device, model):
    """The benchmark's two training models at their widths (a 50 × 3 phone
    loop and a 30-state ergodic HMM with learned transitions, D = 39):
    one ``diag_stats`` launch a ``vb_step`` beside the E-step's two
    kernels, and one a phone-loop ``decode_units`` beside K3 and K4."""
    gen = torch.Generator(device=device).manual_seed(21)
    s = 150 if model == "phone_loop" else 30
    nset = bt.NormalSet.create(torch.zeros(39, device=device), torch.ones(39, device=device),
                               size=s, noise_std=0.5, generator=gen)
    if model == "phone_loop":
        m = bt.PhoneLoop.create(50, 3, nset)
        kernels = ("forward_llh_banded", "estep_acc_banded")
    else:
        m = bt.HMM.create(bt.ergodic(30).compile(device=device), nset, learn_transitions=True)
        kernels = ("forward_llh_dense", "estep_acc_dense")
    x = torch.randn(8, 120, 39, generator=gen, device=device)
    mask = (torch.arange(120, device=device)[None]
            < torch.tensor([[120], [97], [0], [64], [120], [1], [17], [16]], device=device)).float()
    cuda_scan.reset_launch_counts()
    for _ in range(2):
        _, m = bt.vb_step(m, x, mask=mask)
    torch.cuda.synchronize()
    assert _launched() == {"diag_stats": 2, **{k: 2 for k in kernels}}
    if model == "phone_loop":
        cuda_scan.reset_launch_counts()
        with torch.no_grad():
            m.decode_units(x, mask)
        torch.cuda.synchronize()
        assert _launched() == {"diag_stats": 1, "viterbi_fwd_banded": 1, "viterbi_backtrace_banded": 1}


def test_diag_stats_not_on_the_vae_gradient_route(device):
    """A hybrid step of a phone-loop SequenceVAE: its latent frames need a
    gradient, so the statistics keep the plain expression under autograd
    (no ``diag_stats`` launch) while K1 and K11 run; its latent decode,
    under ``no_grad``, launches ``diag_stats`` once."""
    gen = torch.Generator(device=device).manual_seed(5)
    nset = bt.NormalSet.create(torch.zeros(8, device=device), torch.ones(8, device=device),
                               size=12, noise_std=0.5, generator=gen)
    vae = bt.SequenceVAE.create(6, 8, bt.PhoneLoop.create(4, 3, nset), hidden=(16, 16), nsamples=1,
                                generator=torch.Generator().manual_seed(6))
    x = torch.randn(4, 30, 6, generator=gen, device=device)
    mask = (torch.arange(30, device=device)[None]
            < torch.tensor([[30], [17], [1], [30]], device=device)).float()
    step = bt.make_vae_train_step(torch.optim.Adam(vae.parameters(), lr=1e-3))
    cuda_scan.reset_launch_counts()
    elbo = step(vae, x, gen, mask)
    torch.cuda.synchronize()
    launched = _launched()
    assert torch.isfinite(elbo) and "diag_stats" not in launched
    assert launched.get("forward_llh_banded") == 1 and launched.get("estep_gamma_banded") == 1
    cuda_scan.reset_launch_counts()
    vae.latent_decode(x, mask)
    assert _launched() == {"diag_stats": 1, "viterbi_fwd_banded": 1, "viterbi_backtrace_banded": 1}


# (units, states per unit, P, B, T) of K11: config 5 (S=30, P=2·16) and the
# phone loop of config 4 (S=150, P=78); rows 2 and 4 are empty
GAMMA_SHAPES = [(10, 3, 32, 6, 40), (50, 3, 78, 5, 30)]


@pytest.mark.parametrize("shape", GAMMA_SHAPES, ids=lambda s: "S%d_P%d" % (s[0] * s[1], s[2]))
def test_gamma_banded_kernel_matches_plain_version(device, shape):
    u, spu, p_dim, b, t_len = shape
    lengths = [t_len, t_len - 7, 0, 5, 0, 1][:b]
    a = port_args(scan_problem(5, u, spu, p_dim, b, t_len, lengths=lengths), torch.float32, device)
    alpha, norms, _, _ = cuda_scan.forward_llh_banded(a["stats"], a["lens"], a["w"], a["bias"],
                                                      a["bands"], a["init"])
    est = (a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["final"], alpha, norms,
           a["ends"], a["starts"])
    cuda_scan.reset_launch_counts()
    gamma, gamma0, xi = cuda_scan.estep_gamma_banded(*est)
    torch.cuda.synchronize()
    want = cuda_scan.estep_gamma_banded_plain(*est)
    assert float((gamma - want[0]).abs().max()) <= 1e-5
    assert float((gamma0 - want[1]).abs().max()) <= 1e-5
    assert _rel(xi, want[2]) <= 1e-4
    empty = a["lens"] == 0
    assert not gamma[empty].any() and not gamma0[empty].any() and not gamma[1, t_len - 7:].any()
    assert _launched() == {"estep_gamma_banded": 1}
    # reduced, γ gives K2's moments and ξ
    acc2, counts, k2_gamma0, k2_xi = cuda_scan.estep_acc_banded(*est)
    assert _rel(gamma.flatten(0, 1).T @ a["stats"].flatten(0, 1), acc2) <= 1e-4
    assert _rel(gamma.sum((0, 1)), counts) <= 1e-4 and _rel(xi, k2_xi) <= 1e-4
    assert float((gamma0 - k2_gamma0).abs().max()) <= 1e-5


def _launched():
    return {k: v.launches for k, v in cuda_scan.KERNELS.items() if v.launches}


def test_gamma_banded_rejects_what_the_kernel_does_not_take(device):
    a = port_args(scan_problem(6, 3, 2, 4, 3, 9), torch.float32, device)
    alpha, norms, _, _ = cuda_scan.forward_llh_banded(a["stats"], a["lens"], a["w"], a["bias"],
                                                      a["bands"], a["init"])
    est = [a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["final"], alpha, norms,
           a["ends"], a["starts"]]
    with pytest.raises(TypeError):
        cuda_scan.estep_gamma_banded(*est[:8], est[8].long(), est[9])
    with pytest.raises(ValueError):
        cuda_scan.estep_gamma_banded(*est[:6], alpha[:, :-1].contiguous(), *est[7:])
    with pytest.raises(RuntimeError, match="requires grad"):
        cuda_scan.estep_gamma_banded(est[0].clone().requires_grad_(), *est[1:])


def test_autograd_routes_match_plain_route(device):
    """PhoneLoopLogZ (K1 + K11), HMMLogZ (K5 + K7) and EllhFull (K9) on the
    card against their plain routes: log Z and the input gradients."""
    a = port_args(scan_problem(7, 10, 3, 32, 6, 40, lengths=[40, 33, 0, 5, 20, 1]),
                  torch.float32, device)
    d = dense_args(dense_problem(8, 30, 4, 6, 40), torch.float32, device)
    f = _full_args((2, 4, 512), device)
    cases = {
        "PhoneLoopLogZ": (lambda x, plain: tss.PhoneLoopLogZ.apply(
            x, a["lens"], a["w"], a["bias"], a["bands"], a["init"], a["final"], a["ends"],
            a["starts"], plain)[0], a["stats"]),
        "HMMLogZ": (lambda x, plain: tss.HMMLogZ.apply(x, d["lens"], d["trans"], d["init"],
                                                        d["final"], plain)[0], d["llh"]),
        "EllhFull": (lambda x, plain: sk.EllhFull.apply(x, f["e"], plain), f["x"]),
    }
    cuda_scan.reset_launch_counts()
    for name, (fn, x) in cases.items():
        outs = []
        for plain in (False, True):
            leaf = x.clone().requires_grad_()
            out = fn(leaf, plain)
            weights = torch.linspace(0.5, 1.5, out.numel(), device=device).reshape(out.shape)
            (weights * out).sum().backward()
            outs.append((out.detach(), leaf.grad))
        assert _rel(outs[0][0], outs[1][0]) <= 1e-5, name
        assert _rel(outs[0][1], outs[1][1]) <= 1e-4, name
    assert all(_launched().get(k) == 1 for k in (
        "forward_llh_banded", "estep_gamma_banded", "forward_llh_dense", "estep_gamma_dense",
        "ellh_full"))


# ----------------------------------------------------------------------
# The general path: K12 scaled_pass, K13 smoothing_pass; K14, K15
# ----------------------------------------------------------------------
def _e_llh(llh, lens):
    mask = (torch.arange(llh.shape[1], device=llh.device)[None] < lens[:, None]).float()
    e, _ = tss._scaled_likelihoods(llh, mask)
    return e.contiguous(), mask


def _valid_close(got, want, mask, tol, what):
    """Largest abs difference over the valid frames."""
    m = mask[..., None] if got.ndim == 3 else mask
    err = float(((got - want) * m).abs().max())
    assert err <= tol, f"{what}: {err}"


def _general_compare(e, lens, mask, trans, init, final, banded):
    """K12 forward and K13 on these operands against their plain versions."""
    probs, logcs = cuda_scan.scaled_pass(e, lens, trans, init, banded=banded)
    probs_r, logcs_r = cuda_scan.scaled_pass_plain(e, lens, trans, init, banded=banded)
    torch.cuda.synchronize()
    # masked frames repeat the carry, so the whole arrays compare
    assert float((probs - probs_r).abs().max()) <= 1e-5
    assert float((logcs - logcs_r).abs().max() / logcs_r.abs().max().clamp_min(1.0)) <= 1e-5
    got = cuda_scan.smoothing_pass(e, probs, lens, trans, final, banded=banded)
    want = cuda_scan.smoothing_pass_plain(e, probs, lens, trans, final, banded=banded)
    torch.cuda.synchronize()
    assert not got[0][mask == 0].any(), "gamma must be 0 on frames t >= len"
    _valid_close(got[0], want[0], mask, 1e-5, "gamma")
    _valid_close(got[1], want[1], mask, 1e-5, "w_probs")
    for name, x, y in (("w_sums", got[2], want[2]), ("post_norm", got[3], want[3])):
        _valid_close(x, y, mask, 1e-5 * float((y * mask).max().clamp_min(1.0)), name)
    return probs, logcs, got


# (S, B, T): S = 1, S not a multiple of 32, config 2's S, T = 1
GENERAL_DENSE_SHAPES = [(1, 3, 9), (7, 5, 17), (45, 5, 21), (30, 6, 60), (150, 4, 12), (12, 4, 1)]


@pytest.mark.parametrize("shape", GENERAL_DENSE_SHAPES, ids=lambda s: "S%d_T%d" % (s[0], s[2]))
def test_general_dense_kernels_match_plain_versions(device, shape):
    s, b, t_len = shape
    lengths = None if t_len > 8 else np.array([t_len, t_len, 0, t_len][:b])
    a = dense_args(dense_problem(3, s, 4, b, t_len, lengths), torch.float32, device)
    e, mask = _e_llh(a["llh"], a["lens"])
    cuda_scan.reset_launch_counts()
    _general_compare(e, a["lens"], mask, a["trans"], a["init"], a["final"], banded=False)
    beta, logcs = cuda_scan.scaled_pass(e, a["lens"], a["trans"], a["final"], reverse=True)
    beta_r, logcs_r = cuda_scan.scaled_pass_plain(e, a["lens"], a["trans"], a["final"],
                                                  reverse=True)
    torch.cuda.synchronize()
    assert float((beta - beta_r).abs().max()) <= 1e-5
    assert float((logcs - logcs_r).abs().max() / logcs_r.abs().max().clamp_min(1.0)) <= 1e-5
    assert cuda_scan.KERNELS["scaled_pass"].launches == 2
    assert cuda_scan.KERNELS["smoothing_pass"].launches == 1


@pytest.mark.parametrize("shape", SHAPES + [(1, 1, 4, 3, 9), (150, 3, 4, 3, 11)],
                         ids=lambda s: "S%d" % (s[0] * s[1]))
def test_general_banded_kernels_match_plain_and_dense(device, shape):
    u, spu, p_dim, b, t_len = shape
    a = port_args(scan_problem(4, u, spu, p_dim, b, t_len), torch.float32, device)
    llh = (a["stats"] @ a["w"].T + a["bias"]).contiguous()
    e, mask = _e_llh(llh, a["lens"])
    init, final = (a[k].expand(b, -1).contiguous() for k in ("init", "final"))
    probs, logcs, smooth = _general_compare(e, a["lens"], mask, a["bands"], init, final,
                                            banded=True)
    # the dense instances (in device memory above S = 237) give the same
    dense = tss.bands_to_dense(a["bands"]).contiguous()
    probs_d, logcs_d = cuda_scan.scaled_pass(e, a["lens"], dense, init)
    assert float((probs - probs_d).abs().max()) <= 1e-5
    assert float((logcs - logcs_d).abs().max() / logcs_d.abs().max().clamp_min(1.0)) <= 1e-5
    gamma_d = cuda_scan.smoothing_pass(e, probs_d, a["lens"], dense, final)[0]
    assert float((smooth[0] - gamma_d).abs().max()) <= 1e-5


def test_general_dense_kernels_shared_memory_limit(device):
    """The dense instances keep the (S, S) matrix in shared memory up to
    the largest S that fits and read it from device memory above: both
    sides of the limit match the plain versions (the reverse too)."""
    s_max = max(s for s in range(200, 260) if cuda_scan.dense_placement("smoothing_pass", s) == "shared")
    assert s_max == 236
    assert cuda_scan.dense_placement("scaled_pass", 237) == "shared"
    assert cuda_scan.dense_placement("scaled_pass", 238) == "global"
    for s in (s_max, s_max + 1, 260):
        a = dense_args(dense_problem(5, s, 2, 2, 6, np.array([6, 3])), torch.float32, device)
        e, mask = _e_llh(a["llh"], a["lens"])
        _general_compare(e, a["lens"], mask, a["trans"], a["init"], a["final"], banded=False)
        beta, logcs = cuda_scan.scaled_pass(e, a["lens"], a["trans"], a["final"], reverse=True)
        beta_r, logcs_r = cuda_scan.scaled_pass_plain(e, a["lens"], a["trans"], a["final"],
                                                      reverse=True)
        assert float((beta - beta_r).abs().max()) <= 1e-5
        assert float((logcs - logcs_r).abs().max() / logcs_r.abs().max().clamp_min(1.0)) <= 1e-5


def test_general_kernels_all_rows_empty(device):
    a = dense_args(dense_problem(6, 6, 3, 3, 7, np.zeros(3, int)), torch.float32, device)
    e, mask = _e_llh(a["llh"], a["lens"])
    probs, logcs = cuda_scan.scaled_pass(e, a["lens"], a["trans"], a["init"])
    want = a["init"] / a["init"].sum(-1, keepdim=True)
    assert float((probs - want[:, None]).abs().max()) <= 1e-6   # normalise(init), carried
    assert float((logcs - torch.log(a["init"].sum(-1))[:, None]).abs().max()) <= 1e-6
    gamma, w, wsum, pnorm = cuda_scan.smoothing_pass(e, probs, a["lens"], a["trans"], a["final"])
    assert not gamma.any() and bool(torch.isfinite(wsum).all() and torch.isfinite(pnorm).all())
    beta, blog = cuda_scan.scaled_pass(e, a["lens"], a["trans"], a["final"], reverse=True)
    want = a["final"] / a["final"].sum(-1, keepdim=True)
    assert float((beta - want[:, None]).abs().max()) <= 1e-6


def test_general_route_kernels_vs_plain_loops_and_gradient(device):
    """forward_backward_probs / forward_backward / ξ through the kernels
    against ``plain=True`` on the card, and the autograd route's gradient
    against autograd through the plain loops."""
    a = port_args(scan_problem(7, 4, 3, 5, 5, 19), torch.float32, device)
    llh = (a["stats"] @ a["w"].T + a["bias"]).contiguous()
    _, mask = _e_llh(llh, a["lens"])
    log_trans = torch.log(tss.bands_to_dense(a["bands"]).clamp_min(1e-37))
    log_init, log_final = (torch.log(a[k].clamp_min(1e-37)) for k in ("init", "final"))
    full = a["lens"] > 0
    for bands in (None, a["bands"]):
        cuda_scan.reset_launch_counts()
        got = tss.forward_backward_probs(llh, log_trans, log_init, log_final, mask,
                                         structured_trans=bands)
        assert cuda_scan.KERNELS["scaled_pass"].launches == 1
        assert cuda_scan.KERNELS["smoothing_pass"].launches == 1
        want = tss.forward_backward_probs(llh, log_trans, log_init, log_final, mask,
                                          structured_trans=bands, plain=True)
        assert cuda_scan.KERNELS["scaled_pass"].launches == 1   # plain launches nothing
        assert _rel(got.log_z[full], want.log_z[full]) <= 1e-5
        assert float((got.posteriors - want.posteriors).abs().max()) <= 1e-5
        xi, xi_r = (tss.expected_transition_counts_probs(f, log_trans, mask) for f in (got, want))
        assert _rel(xi, xi_r) <= 1e-4
    # (a row too short to reach an end state has log Z near log FLT_MIN,
    # where the dense matrix's floored zeros show: compare dense with dense)
    got = tss.forward_backward_probs(llh, log_trans, log_init, log_final, mask)
    cuda_scan.reset_launch_counts()
    fb = tss.forward_backward(llh, log_trans, log_init, log_final, mask)
    assert cuda_scan.KERNELS["scaled_pass"].launches == 2       # forward + reverse
    assert _rel(fb.log_z[full], got.log_z[full]) <= 1e-5
    assert float((fb.posteriors - got.posteriors).abs().max()) <= 1e-4
    grads = []
    for plain in (False, True):
        x = llh.clone().requires_grad_()
        out = tss.forward_backward_probs(x, log_trans, log_init, log_final, mask, plain=plain)
        weights = torch.linspace(0.5, 1.5, out.posteriors.shape[-1], device=device)
        (out.log_z[full].sum() + (out.posteriors * weights).sum()).backward()
        grads.append(x.grad)
    assert _rel(grads[0], grads[1]) <= 1e-4
    with pytest.raises(RuntimeError, match="requires grad"):
        e, _ = _e_llh(llh, a["lens"])
        cuda_scan.scaled_pass(e.requires_grad_(), a["lens"], torch.exp(log_trans).contiguous(),
                              a["init"].expand(5, -1).contiguous())


@pytest.mark.parametrize("shape", [(1, 3, 9), (7, 5, 17), (30, 6, 60), (150, 4, 12), (12, 4, 1)],
                         ids=lambda s: "S%d_T%d" % (s[0], s[2]))
def test_forward_llh_shifts_and_restricted_estep_match_plain(device, shape):
    """K14 and K15 against their plain versions, and K15's block against
    the gather of K7's full ξ."""
    s, b, t_len = shape
    lengths = None if t_len > 8 else np.array([t_len, t_len, 0, t_len][:b])
    a = dense_args(dense_problem(8, s, 4, b, t_len, lengths), torch.float32, device)
    cuda_scan.reset_launch_counts()
    got = cuda_scan.forward_llh_dense(a["llh"], a["lens"], a["trans"], a["init"],
                                      return_shifts=True)
    want = cuda_scan.forward_llh_dense_plain(a["llh"], a["lens"], a["trans"], a["init"],
                                             return_shifts=True)
    torch.cuda.synchronize()
    assert cuda_scan.KERNELS["forward_llh_shifts_dense"].launches == 1
    assert cuda_scan.KERNELS["forward_llh_dense"].launches == 0
    for name, x, y, tol in (("alpha", got[0], want[0], 1e-5), ("last", got[2], want[2], 1e-5),
                            ("shifts", got[4], want[4], 0.0)):
        assert float((x - y).abs().max()) <= tol, name
    assert _rel(got[1], want[1]) <= 1e-5 and _rel(got[3], want[3]) <= 1e-5
    rng = np.random.default_rng(0)
    rows = t(np.sort(rng.choice(s, size=max(s // 3, 1), replace=False)), torch.int32).to(device)
    cols = t(rng.permutation(s)[: max(s // 2, 1)], torch.int32).to(device)
    # K15 reads only valid frames of α̂, so it takes K14's or K5's
    est = (a["llh"], a["lens"], a["trans"], a["final"], got[0], got[1])
    gamma, xi = cuda_scan.estep_gamma_dense(*est, rows=rows, cols=cols)
    gamma_r, xi_r = cuda_scan.estep_gamma_dense_plain(*est, rows=rows, cols=cols)
    gamma_f, xi_f = cuda_scan.estep_gamma_dense(*est)
    torch.cuda.synchronize()
    assert cuda_scan.KERNELS["estep_gamma_dense_restricted"].launches == 1
    assert float((gamma - gamma_r).abs().max()) <= 1e-5 and torch.equal(gamma, gamma_f)
    assert xi.shape == (rows.numel(), cols.numel())
    scale = xi_f.abs().max().clamp_min(1e-30)
    assert float((xi - xi_r).abs().max() / scale) <= 1e-4
    assert float((xi - xi_f[rows.long()][:, cols.long()]).abs().max() / scale) <= 1e-6
    with pytest.raises(ValueError):
        cuda_scan.estep_gamma_dense(*est, rows=rows)
    with pytest.raises(ValueError):
        cuda_scan.estep_gamma_dense(*est, rows=rows + s, cols=cols)


def _forward_matches_plain(a, stats_stream=True):
    """K5 (on the statistics stream when asked, and on the llh stream) and
    K14 against their plain versions on :func:`dense_args` operands."""
    full = a["lens"] > 0
    tiny = torch.finfo(torch.float32).tiny
    cuda_scan.reset_launch_counts()
    streams = [(a["llh"], a["lens"], a["trans"], a["init"])]
    if stats_stream:
        streams.insert(0, (a["stats"], a["lens"], a["trans"], a["init"], a["w"], a["bias"]))
    for args in streams:
        got = cuda_scan.forward_llh_dense(*args)
        want = cuda_scan.forward_llh_dense_plain(*args)
        torch.cuda.synchronize()
        log_z = [o[3] + torch.log((o[2] * a["final"]).sum(-1).clamp_min(tiny)) for o in (got, want)]
        assert _rel(log_z[0][full], log_z[1][full]) <= 1e-5
        assert float((got[0] - want[0]).abs().max()) <= 1e-5
        assert _rel(got[1], want[1]) <= 1e-5
        assert torch.equal(got[2][~full], a["init"][~full]) and not got[3][~full].any()
    got = cuda_scan.forward_llh_dense(a["llh"], a["lens"], a["trans"], a["init"], return_shifts=True)
    want = cuda_scan.forward_llh_dense_plain(a["llh"], a["lens"], a["trans"], a["init"],
                                             return_shifts=True)
    torch.cuda.synchronize()
    for name, x, y, tol in (("alpha", got[0], want[0], 1e-5), ("last", got[2], want[2], 1e-5),
                            ("shifts", got[4], want[4], 0.0)):
        assert float((x - y).abs().max()) <= tol, name
    assert _rel(got[1], want[1]) <= 1e-5 and _rel(got[3], want[3]) <= 1e-5
    assert _launched() == {"forward_llh_dense": len(streams), "forward_llh_shifts_dense": 1}


@pytest.mark.parametrize("s", [1, 18, 30, 32, 33, 150, 300])
def test_forward_instances_match_plain_versions(device, s):
    """K5 (statistics and llh stream) and K14 in the instance each S takes
    (one warp an utterance up to 32, a block above; at 300 the global
    placement) against their plain versions: T = 70 (two whole chunks and
    a ragged one), rows of length T, T − 7, 5 and 0; then an empty batch."""
    _forward_matches_plain(dense_args(dense_problem(9 + s, s, 78, 6, 70), torch.float32, device))
    empty = dense_args(dense_problem(1, s, 78, 0, 9, lengths=np.zeros(0, int)), torch.float32, device)
    for shifts in (False, True):
        out = cuda_scan.forward_llh_dense(empty["llh"], empty["lens"], empty["trans"], empty["init"],
                                          return_shifts=shifts)
        assert out[0].shape == (0, 9, s) and out[1].shape == (0, 9)


@pytest.mark.parametrize("case", [
    # (S, P; P = 0: the llh stream alone) -> K5's (instance, frames a chunk) on that stream
    ((30, 200), ("shared", 16)), ((30, 2000), ("global", 8)), ((200, 78), ("shared", 4)),
    ((230, 0), ("shared", 8)), ((238, 0), ("shared", 1)), ((2000, 0), ("global", 8)),
], ids=lambda c: "S%d_P%d" % c[0] if isinstance(c[0], tuple) else str(c))
def test_forward_large_p_and_short_chunks_match_plain_versions(device, case):
    """K5 and K14 where the warp instance's ring does not fit (S <= 32 at
    large P: the block instance), and where the block instance shortens
    its chunks near a placement's limit, against their plain versions:
    T = 37 (ragged in every chunk length), rows of length T, T − 7, 5 and
    0.  W is scaled by sqrt(78 / P) so that llh keeps the magnitudes of
    the P = 78 cases, whose tolerances these share."""
    (s, p_dim), want = case
    assert cuda_scan.forward_instance(s, p_dim) == want
    pb = dense_problem(40 + s, s, p_dim or 8, 4, 37)
    pb["w"] = pb["w"] * min(1.0, (78 / (p_dim or 8)) ** 0.5)
    _forward_matches_plain(dense_args(pb, torch.float32, device), stats_stream=p_dim > 0)


# ----------------------------------------------------------------------
# Every S the reference takes: the dense kernels' global placement
# ----------------------------------------------------------------------
def _hmm_estep(model, x, m):
    """log Z, the accumulated statistics (leaves in key order), the ξ
    counts, the ELBO and the posteriors of one E-step of ``model``."""
    stats = model.sufficient_statistics(x)
    log_z, cache = model.infer(stats, m)
    acc = model.accumulate(stats, cache)
    leaves = []
    for key in sorted(acc["modelset"]):
        leaves.append(acc["modelset"][key])
    elbo = bt.evidence_lower_bound(copy.deepcopy(model), x, mask=m).value
    return dict(log_z=log_z, leaves=leaves, xi=model.expected_transition_counts(cache),
                elbo=elbo, post=model.posteriors(x, m))


def _routes_agree(model, x, m, need):
    """The kernel route of ``model`` against its plain route on the card:
    log Z and ELBO rel 1e-5, γ abs 1e-5, statistics and ξ rel 1e-4, and
    every kernel of ``need`` launched."""
    plain = copy.deepcopy(model)
    for module in plain.modules():            # the HMM's scans and its NormalSet's statistics
        if hasattr(module, "plain_scan"):
            module.plain_scan = True
    cuda_scan.reset_launch_counts()
    got = _hmm_estep(model, x, m)
    torch.cuda.synchronize()
    launched = _launched()
    want = _hmm_estep(plain, x, m)
    assert _launched() == launched                      # the plain route launches nothing
    assert all(launched.get(k, 0) > 0 for k in need), launched
    full = m.sum(-1) > 0
    assert _rel(got["log_z"][full], want["log_z"][full]) <= 1e-5
    assert _rel(got["elbo"], want["elbo"]) <= 1e-5
    assert float((got["post"] - want["post"]).abs().max()) <= 1e-5
    for g, w in zip(got["leaves"], want["leaves"]):
        assert _rel(g, w) <= 1e-4
    assert _rel(got["xi"], want["xi"]) <= 1e-4


@pytest.mark.parametrize("s", [180, 300])
def test_large_ergodic_hmm_runs_through_the_kernels(device, s):
    """An ergodic HMM with learned transitions above the shared-memory
    limit of K6/K7 (and at 300 of K5): stats route (K5 + K6) and
    posteriors (K5 + K7) through the global placement."""
    gen = torch.Generator(device=device).manual_seed(s)
    nset = bt.NormalSet.create(torch.zeros(6, device=device), torch.ones(6, device=device),
                               size=s, noise_std=0.5, generator=gen)
    hmm = bt.HMM.create(bt.ergodic(s).compile(device=device), nset, learn_transitions=True)
    assert hmm.route() == "stats"
    rng = np.random.default_rng(s)
    x = torch.from_numpy(rng.normal(size=(4, 40, 6)).astype(np.float32)).to(device)
    m = (torch.arange(40, device=device)[None] < torch.tensor([[40], [33], [0], [7]],
                                                              device=device)).float()
    _routes_agree(hmm, x, m, ("forward_llh_dense", "estep_acc_dense", "estep_gamma_dense"))


def test_long_transcription_chain_runs_through_the_kernels(device):
    """A shared left-to-right graph of 60 phones × 3 states (S = 180), as
    a forced alignment of long transcriptions builds it: llh route (K5 +
    K7)."""
    rng = np.random.default_rng(6)
    seqs = [list(rng.integers(10, size=n)) for n in (60, 58, 45, 60)]
    graphs = bt.transcription_graphs(seqs, 10, 3, device=device)
    assert graphs.n_states == 180
    gen = torch.Generator(device=device).manual_seed(6)
    nset = bt.NormalSet.create(torch.zeros(6, device=device), torch.ones(6, device=device),
                               size=30, noise_std=0.5, generator=gen)
    hmm = bt.HMM.create(graphs, nset)
    assert hmm.route() == "llh"
    x = torch.from_numpy(rng.normal(size=(4, 240, 6)).astype(np.float32)).to(device)
    m = (torch.arange(240, device=device)[None] < torch.tensor([[240], [220], [200], [240]],
                                                               device=device)).float()
    _routes_agree(hmm, x, m, ("forward_llh_dense", "estep_gamma_dense"))


def test_large_dense_forward_backward_probs_runs_through_the_kernels(device):
    """``forward_backward_probs`` on one shared (S, S) matrix at S = 300
    without bands: K12 dense forward + K13 dense against the plain loops."""
    a = dense_args(dense_problem(9, 300, 4, 4, 30), torch.float32, device)
    _, mask = _e_llh(a["llh"], a["lens"])
    log_trans = torch.log(a["trans"].clamp_min(1e-37))
    log_init = torch.log(a["init"][0].clamp_min(1e-37))
    log_final = torch.log(a["final"][0].clamp_min(1e-37))
    full = a["lens"] > 0
    cuda_scan.reset_launch_counts()
    got = tss.forward_backward_probs(a["llh"], log_trans, log_init, log_final, mask)
    torch.cuda.synchronize()
    assert _launched() == {"scaled_pass": 1, "smoothing_pass": 1}
    want = tss.forward_backward_probs(a["llh"], log_trans, log_init, log_final, mask, plain=True)
    assert _rel(got.log_z[full], want.log_z[full]) <= 1e-5
    assert float((got.posteriors - want.posteriors).abs().max()) <= 1e-5
    xi, xi_r = (tss.expected_transition_counts_probs(f, log_trans, mask) for f in (got, want))
    assert _rel(xi, xi_r) <= 1e-4


@pytest.mark.parametrize("placement", ["shared", "global"])
def test_dense_smem_formulas_match_the_library(device, placement):
    """``cuda_scan.dense_smem_bytes`` (which picks the placement) counts what
    the kernels' own launchers reserve."""
    lib = cuda_scan._library()
    glob = int(placement == "global")
    for s in (1, 7, 30, 150, 168, 169, 237, 300, 1100):
        for p in (0, 4, 78, 186, 512):
            code = cuda_scan._INSTANCES.index(placement)
            for chunk in cuda_scan.FORWARD_CHUNKS:
                assert cuda_scan.forward_smem_bytes(s, p, placement, chunk) == \
                    lib.beer_dense_forward_smem_bytes(s, p, code, chunk)
            assert cuda_scan.dense_smem_bytes("forward_llh_dense", s, p, placement=placement) == \
                lib.beer_dense_forward_smem_bytes(s, p, code, cuda_scan.forward_chunk(s, p, placement))
            if s <= 32:
                assert cuda_scan.forward_smem_bytes(s, p, "warp") == \
                    lib.beer_dense_forward_smem_bytes(s, p, 2, cuda_scan.FORWARD_CHUNK)
            if p == 0:
                for chunk in cuda_scan.BACKWARD_CHUNKS:
                    assert cuda_scan.gamma_smem_bytes(s, placement, chunk) == \
                        lib.beer_gamma_dense_smem_bytes(s, s, s, 0, code, chunk, 1)
                assert cuda_scan.dense_smem_bytes("estep_gamma_dense", s, placement=placement) == \
                    lib.beer_gamma_dense_smem_bytes(s, s, s, 0, code, cuda_scan.gamma_chunk(s, placement), 1)
                if s <= 32:
                    for n_utt in cuda_scan.ACC_UTTERANCES:
                        assert cuda_scan.gamma_smem_bytes(s, "warp", 16, n_utt) == \
                            lib.beer_gamma_dense_smem_bytes(s, s, s, 0, 2, 16, n_utt)
                        assert cuda_scan.gamma_smem_bytes(s, "warp", 16, n_utt, s // 3 + 1, s // 2 + 1) == \
                            lib.beer_gamma_dense_smem_bytes(s, s // 3 + 1, s // 2 + 1, 1, 2, 16, n_utt)
                continue
            for chunk in cuda_scan.BACKWARD_CHUNKS:
                assert cuda_scan.backward_smem_bytes(s, p, placement, chunk) == \
                    lib.beer_acc_dense_smem_bytes(s, p, code, chunk, 1)
            assert cuda_scan.dense_smem_bytes("estep_acc_dense", s, p, placement=placement) == \
                lib.beer_acc_dense_smem_bytes(s, p, code, cuda_scan.backward_chunk(s, p, placement), 1)
            if s <= 32:
                for n_utt in cuda_scan.ACC_UTTERANCES:
                    assert cuda_scan.backward_smem_bytes(s, p, "warp", cuda_scan.BACKWARD_CHUNK, n_utt) == \
                        lib.beer_acc_dense_smem_bytes(s, p, 2, cuda_scan.BACKWARD_CHUNK, n_utt)
        n_r, n_c = s // 3 + 1, s // 2 + 1
        assert cuda_scan.dense_smem_bytes("estep_gamma_dense_restricted", s, n_r=n_r, n_c=n_c,
                                          placement=placement) == \
            lib.beer_gamma_dense_smem_bytes(s, n_r, n_c, 1, glob, cuda_scan.gamma_chunk(s, placement, n_r, n_c), 1)
        ks = cuda_scan.grouped_slices(s)
        for mode in (0, 2):
            assert cuda_scan.dense_smem_bytes("scaled_pass", s, placement=placement) == \
                lib.beer_scaled_pass_smem_bytes(mode, s, glob, 1, ks)
            for n_utt in cuda_scan.GRP_UTTERANCES:
                assert cuda_scan.grouped_smem_bytes("scaled_pass", s, placement, n_utt) == \
                    lib.beer_scaled_pass_smem_bytes(mode, s, glob, n_utt, ks)
        assert cuda_scan.dense_smem_bytes("smoothing_pass", s, placement=placement) == \
            lib.beer_smoothing_smem_bytes(s, glob, 1, ks)
        for n_utt in cuda_scan.GRP_UTTERANCES:
            assert cuda_scan.grouped_smem_bytes("smoothing_pass", s, placement, n_utt) == \
                lib.beer_smoothing_smem_bytes(s, glob, n_utt, ks)


def test_accumulate_full_takes_an_unaligned_view(device):
    """K10 copies 16 bytes at a time; a view starting mid-row still works."""
    a = _full_args((5, 8, 300), device)
    x, r = a["x"][3:], a["r"][3:]
    assert x.data_ptr() % 16 and x.is_contiguous()
    assert _rel(sk.accumulate_full(x, r), sk.accumulate_full_plain(x, r)) <= 1e-4


# ----------------------------------------------------------------------
# K2 and K6 (B2) in chunks, and every phone loop through K1, K2 and K11
# ----------------------------------------------------------------------
# lengths around a chunk of C frames: 0, 1, C − 1, C, C + 1, several chunks
# and a ragged end
def _chunk_lengths(c, t_len):
    return [t_len, 0, 1, c - 1, c, c + 1, 2 * c + 3, t_len - 7]


def _banded_close(got, want):
    for name, i in (("acc2", 0), ("counts", 1), ("xi", 3)):
        assert _rel(got[i], want[i]) <= 1e-4, name
    assert float((got[2] - want[2]).abs().max()) <= 1e-5, "gamma0"


# (units, states per unit, P, forced (placement, utterances a block, frames a chunk))
ACC_BANDED_CASES = [(50, 3, 78, g) for g in (("shared", 2, 16), ("shared", 1, 16), ("global", 4, 16),
                                              ("global", 2, 8), ("global", 1, 1), ("shared", 4, 4))] + \
                   [(10, 3, 32, ("shared", 4, 16)), (1, 1, 5, ("shared", 4, 2)), (100, 3, 78, ("global", 2, 16))]


@pytest.mark.parametrize("case", ACC_BANDED_CASES, ids=lambda c: "U%d_P%d_%s_u%d_c%d" % (c[0], c[2], *c[3]))
def test_acc_banded_geometries_match_plain_version(device, monkeypatch, case):
    """K2 in each launch geometry (forced), against its plain version:
    lengths 0, 1, C − 1, C, C + 1 and across chunks, a block of utterances
    that the batch does not fill."""
    units, spu, p_dim, geometry = case
    chunk = geometry[2]
    lengths = _chunk_lengths(chunk, 3 * chunk + 5)[: 7 if geometry[1] == 4 else 8]
    a = port_args(scan_problem(units + chunk, units, spu, p_dim, len(lengths), max(lengths),
                               lengths=lengths), torch.float32, device)
    fwd = (a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["init"])
    alpha, norms, _, _ = cuda_scan.forward_llh_banded_plain(*fwd)
    est = (a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["final"], alpha, norms,
           a["ends"], a["starts"])
    monkeypatch.setattr(cuda_scan, "acc_banded_geometry", lambda *args: geometry)
    got = cuda_scan.estep_acc_banded(*est)
    torch.cuda.synchronize()
    _banded_close(got, cuda_scan.estep_acc_banded_plain(*est))
    assert not got[2][a["lens"] == 0].any()


# (S, P, forced (instance, frames a chunk) or None for the wrapper's own[,
# forced utterances a block]): at these eight rows the warp instance takes
# one utterance a block; four and two are forced
ACC_DENSE_CASES = [(1, 78, None), (18, 78, None), (30, 78, None), (32, 78, None), (30, 400, None),
                   (33, 78, None), (100, 12, ("shared", 8)), (100, 12, ("shared", 1)), (133, 78, None),
                   (150, 78, None), (150, 12, ("global", 4)), (300, 78, None),
                   (30, 78, None, 4), (18, 78, None, 2)]


@pytest.mark.parametrize("case", ACC_DENSE_CASES, ids=lambda c: "S%d_P%d_%s" % (c[0], c[1], c[2] and c[2][0])
                         + ("_u%d" % c[3] if len(c) > 3 else ""))
def test_acc_dense_instances_match_plain_version(device, monkeypatch, case):
    """K6 in the instance each S takes (one warp an utterance up to 32, a
    block above, global at 150 and 300 at P = 78) or a forced one, and the
    warp instance with four and two utterances a block (a block the batch
    does not fill), against its plain version: lengths 0, 1, C − 1, C,
    C + 1 and across chunks."""
    s, p_dim, forced = case[:3]
    if forced is not None:
        monkeypatch.setattr(cuda_scan, "backward_instance", lambda s_, p_: forced)
    if len(case) > 3:
        monkeypatch.setattr(cuda_scan, "backward_utterances", lambda *args: case[3])
    chunk = (forced or cuda_scan.backward_instance(s, p_dim))[1]
    lengths = _chunk_lengths(chunk, 3 * chunk + 5)
    pb = dense_problem(s + p_dim, s, p_dim, len(lengths), max(lengths), lengths=lengths)
    pb["w"] = pb["w"] * min(1.0, (78 / p_dim) ** 0.5)
    a = dense_args(pb, torch.float32, device)
    f = cuda_scan.forward_llh_dense_plain(a["stats"], a["lens"], a["trans"], a["init"], a["w"], a["bias"])
    est = (a["stats"], a["lens"], a["w"], a["bias"], a["trans"], a["final"], f[0], f[1])
    got = cuda_scan.estep_acc_dense(*est)
    torch.cuda.synchronize()
    _banded_close(got, cuda_scan.estep_acc_dense_plain(*est))


@pytest.mark.parametrize("units", [100, 250])
def test_large_phone_loops_run_through_the_banded_kernels(device, units):
    """K1, K2 and K11 at 100 units (S = 300 at B = 5: K1 shared, K2 global;
    K2 was refused there before PR 8's global placement) and 250 units (S =
    750: all three global), P = 78, against their plain versions."""
    a = port_args(scan_problem(units, units, 3, 78, 5, 40), torch.float32, device)
    n_sm = cuda_scan.sm_count(a["stats"].device.index)
    assert cuda_scan.forward_banded_geometry(3 * units, 78, 5, n_sm) == \
        (("shared", 1, 16) if units == 100 else ("global", 1, 16))
    assert cuda_scan.acc_banded_geometry(3 * units, 78, units, 5, n_sm) == ("global", 1, 16)
    fwd = (a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["init"])
    cuda_scan.reset_launch_counts()
    alpha, norms, last, logz = cuda_scan.forward_llh_banded(*fwd)
    ref = cuda_scan.forward_llh_banded_plain(*fwd)
    torch.cuda.synchronize()
    assert float((alpha - ref[0]).abs().max()) <= 1e-5 and _rel(logz, ref[3]) <= 1e-5
    est = (a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["final"], alpha, norms,
           a["ends"], a["starts"])
    _banded_close(cuda_scan.estep_acc_banded(*est), cuda_scan.estep_acc_banded_plain(*est))
    gamma = cuda_scan.estep_gamma_banded(*est)
    want = cuda_scan.estep_gamma_banded_plain(*est)
    assert float((gamma[0] - want[0]).abs().max()) <= 1e-5 and _rel(gamma[2], want[2]) <= 1e-4
    assert _launched() == {"forward_llh_banded": 1, "estep_acc_banded": 1, "estep_gamma_banded": 1}


def test_hundred_unit_vb_step_runs_through_the_kernels(device):
    """Two VB steps of a 100-unit phone loop (S = 300, D = 39) through K1 +
    K2 on the card, within 1e-4 per frame of the plain route; K1 and K2 on
    the loop's own operands (K2's geometry: global, an utterance a block,
    16 frames a chunk; lengths 0, 1, 16, 17 among them) against their
    plain versions.  The second step's ELBO reads the update made from
    K2's statistics."""
    gen = torch.Generator(device=device).manual_seed(100)
    nset = bt.NormalSet.create(torch.zeros(39, device=device), torch.ones(39, device=device),
                               size=300, noise_std=0.5, generator=gen)
    loop = bt.PhoneLoop.create(100, 3, nset)
    plain = copy.deepcopy(loop)
    plain.plain_scan = True
    rng = np.random.default_rng(100)
    x = torch.from_numpy(rng.normal(size=(8, 120, 39)).astype(np.float32)).to(device)
    m = (torch.arange(120, device=device)[None] < torch.tensor([[120], [97], [0], [64], [120], [1], [17], [16]],
                                                               device=device)).float()
    with torch.no_grad():
        stats = loop.sufficient_statistics(x).contiguous()
        ops = loop.scan_operands(stats, m)
        fwd = (stats, ops["lens"], ops["w"], ops["bias"], ops["bands"], ops["init"])
        alpha, norms, _, logz = cuda_scan.forward_llh_banded(*fwd)
        ref = cuda_scan.forward_llh_banded_plain(*fwd)
        assert float((alpha - ref[0]).abs().max()) <= 1e-5 and _rel(logz, ref[3]) <= 1e-5
        est = (stats, ops["lens"], ops["w"], ops["bias"], ops["bands"], ops["final"], alpha, norms,
               ops["ends"], ops["starts"])
        _banded_close(cuda_scan.estep_acc_banded(*est), cuda_scan.estep_acc_banded_plain(*est))
    cuda_scan.reset_launch_counts()
    elbos = []
    for _ in range(2):
        elbo, loop = bt.vb_step(loop, x, mask=m)
        elbos.append(float(elbo))
    torch.cuda.synchronize()
    assert _launched() == {"diag_stats": 2, "forward_llh_banded": 2, "estep_acc_banded": 2}
    for got in elbos:
        elbo, plain = bt.vb_step(plain, x, mask=m)
        assert abs(got - float(elbo)) / float(m.sum()) <= 1e-4


def test_redesigned_kernels_are_deterministic(device):
    """Two calls of K1, K2, K3, K4, K6, K7, K11, K12 (every instance), K13
    (both) and K15 agree bitwise: every sum runs in a fixed order."""
    a = port_args(scan_problem(5, 50, 3, 78, 9, 70), torch.float32, device)
    fwd = (a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["init"])
    for x, y in zip(cuda_scan.forward_llh_banded(*fwd), cuda_scan.forward_llh_banded(*fwd)):
        assert torch.equal(x, y)
    alpha, norms, _, _ = cuda_scan.forward_llh_banded(*fwd)
    est = (a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["final"], alpha, norms, a["ends"], a["starts"])
    for x, y in zip(cuda_scan.estep_acc_banded(*est), cuda_scan.estep_acc_banded(*est)):
        assert torch.equal(x, y)
    for x, y in zip(cuda_scan.estep_gamma_banded(*est), cuda_scan.estep_gamma_banded(*est)):
        assert torch.equal(x, y)
    vit = ((a["stats"] @ a["w"].T + a["bias"]).contiguous(), a["lens"], tss.log_bands(a["bands"]).contiguous(),
           tss.log_bands(a["init"]).contiguous())
    for x, y in zip(cuda_scan.viterbi_fwd_banded(*vit), cuda_scan.viterbi_fwd_banded(*vit)):
        assert torch.equal(x, y)
    back = (*cuda_scan.viterbi_fwd_banded(*vit), tss.log_bands(a["final"]).contiguous())
    for x, y in zip(cuda_scan.viterbi_backtrace_banded(*back), cuda_scan.viterbi_backtrace_banded(*back)):
        assert torch.equal(x, y)
    e, _ = _e_llh(vit[0], a["lens"])
    init, final = (a[k].expand(9, -1).contiguous() for k in ("init", "final"))
    fwd = (e, a["lens"], a["bands"], init)
    for x, y in zip(cuda_scan.scaled_pass(*fwd, banded=True), cuda_scan.scaled_pass(*fwd, banded=True)):
        assert torch.equal(x, y)
    smo = (e, cuda_scan.scaled_pass(*fwd, banded=True)[0], a["lens"], a["bands"], final)
    for x, y in zip(cuda_scan.smoothing_pass(*smo, banded=True), cuda_scan.smoothing_pass(*smo, banded=True)):
        assert torch.equal(x, y)
    dense = tss.bands_to_dense(a["bands"]).contiguous()
    for vec, reverse in ((init, False), (final, True)):
        got = [cuda_scan.scaled_pass(e, a["lens"], dense, vec, reverse=reverse) for _ in range(2)]
        for x, y in zip(*got):
            assert torch.equal(x, y)
    smo = (e, smo[1], a["lens"], dense, final)
    for x, y in zip(cuda_scan.smoothing_pass(*smo), cuda_scan.smoothing_pass(*smo)):
        assert torch.equal(x, y)
    for s in (30, 150):
        d = dense_args(dense_problem(s, s, 78, 9, 70), torch.float32, device)
        f = cuda_scan.forward_llh_dense(d["stats"], d["lens"], d["trans"], d["init"], d["w"], d["bias"])
        est = (d["stats"], d["lens"], d["w"], d["bias"], d["trans"], d["final"], f[0], f[1])
        for x, y in zip(cuda_scan.estep_acc_dense(*est), cuda_scan.estep_acc_dense(*est)):
            assert torch.equal(x, y)
        gam = (d["llh"], d["lens"], d["trans"], d["final"], f[0], f[1])
        ids = torch.arange(s, device=device, dtype=torch.int32)
        for kw in ({}, dict(rows=ids[::3].contiguous(), cols=ids[::2].contiguous())):
            for x, y in zip(cuda_scan.estep_gamma_dense(*gam, **kw), cuda_scan.estep_gamma_dense(*gam, **kw)):
                assert torch.equal(x, y)


def test_banded_smem_formulas_match_the_library(device):
    """``cuda_scan.forward_banded_smem_bytes``, ``acc_banded_smem_bytes``,
    ``gamma_banded_smem_bytes``, ``viterbi_banded_smem_bytes``,
    ``smoothing_banded_smem_bytes``, ``scaled_banded_smem_bytes`` and
    ``backtrace_smem_bytes`` count what the banded launchers reserve."""
    lib = cuda_scan._library()
    for s, p, u in ((30, 32, 10), (150, 78, 50), (300, 78, 100), (675, 78, 225), (30, 2000, 10), (4, 5, 1)):
        for placement in ("shared", "global"):
            glob = int(placement == "global")
            for n_utt in cuda_scan.ACC_UTTERANCES:
                for chunk in cuda_scan.ACC_CHUNKS:
                    assert cuda_scan.forward_banded_smem_bytes(s, p, placement, n_utt, chunk) == \
                        lib.beer_forward_smem_bytes(s, p, glob, n_utt, chunk)
            for n_utt in cuda_scan.ACC_UTTERANCES:
                for chunk in cuda_scan.ACC_CHUNKS:
                    assert cuda_scan.acc_banded_smem_bytes(s, p, u, placement, n_utt, chunk) == \
                        lib.beer_estep_smem_bytes(s, p, u, glob, n_utt, chunk)
                    assert cuda_scan.gamma_banded_smem_bytes(s, p, u, placement, n_utt, chunk) == \
                        lib.beer_estep_gamma_smem_bytes(s, p, u, glob, n_utt, chunk)
                    assert cuda_scan.viterbi_banded_smem_bytes(s, placement, n_utt, chunk) == \
                        lib.beer_viterbi_smem_bytes(s, glob, n_utt, chunk)
                    assert cuda_scan.smoothing_banded_smem_bytes(s, placement, n_utt, chunk) == \
                        lib.beer_smoothing_banded_smem_bytes(s, glob, n_utt, chunk)
                    assert cuda_scan.scaled_banded_smem_bytes(s, placement, n_utt, chunk) == \
                        lib.beer_scaled_pass_smem_bytes(1, s, glob, n_utt, chunk)
                    assert cuda_scan.backtrace_smem_bytes(s, n_utt, chunk) == \
                        lib.beer_backtrace_smem_bytes(s, n_utt, chunk)


def test_large_p_runs_through_the_backward_kernels(device):
    """P = 2000 (W in device memory, shorter chunks): K1, K2 and K11 on a
    10-unit loop and K6 at S = 30 against their plain versions; W is
    scaled by sqrt(78 / P) so that llh keeps the magnitudes of the P = 78
    cases, whose tolerances these share."""
    pb = scan_problem(2000, 10, 3, 2000, 5, 37)
    pb["w"] = pb["w"] * (78 / 2000) ** 0.5
    a = port_args(pb, torch.float32, device)
    n_sm = cuda_scan.sm_count(a["stats"].device.index)
    assert cuda_scan.acc_banded_geometry(30, 2000, 10, 5, n_sm) == ("global", 1, 8)
    assert cuda_scan.banded_placement("forward_llh_banded", 30, 2000, 10, 5, n_sm) == "global"
    fwd = (a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["init"])
    alpha, norms, _, logz = cuda_scan.forward_llh_banded(*fwd)
    ref = cuda_scan.forward_llh_banded_plain(*fwd)
    torch.cuda.synchronize()
    assert float((alpha - ref[0]).abs().max()) <= 1e-5 and _rel(logz, ref[3]) <= 1e-5
    est = (a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["final"], alpha, norms,
           a["ends"], a["starts"])
    _banded_close(cuda_scan.estep_acc_banded(*est), cuda_scan.estep_acc_banded_plain(*est))
    gamma = cuda_scan.estep_gamma_banded(*est)
    want = cuda_scan.estep_gamma_banded_plain(*est)
    assert float((gamma[0] - want[0]).abs().max()) <= 1e-5 and _rel(gamma[2], want[2]) <= 1e-4
    d = dense_problem(2001, 30, 2000, 5, 37)
    d["w"] = d["w"] * (78 / 2000) ** 0.5
    d = dense_args(d, torch.float32, device)
    assert cuda_scan.backward_instance(30, 2000) == ("global", 8)
    f = cuda_scan.forward_llh_dense_plain(d["stats"], d["lens"], d["trans"], d["init"], d["w"], d["bias"])
    est = (d["stats"], d["lens"], d["w"], d["bias"], d["trans"], d["final"], f[0], f[1])
    _banded_close(cuda_scan.estep_acc_dense(*est), cuda_scan.estep_acc_dense_plain(*est))


# ----------------------------------------------------------------------
# K7 / K15 (B7, B11) and K1 (B1) in chunks
# ----------------------------------------------------------------------
# (S, forced (instance, frames a chunk, utterances a block) or None for the
# wrapper's own): the warp instance at configs 3 and 2 (S = 18, 30) with
# four, two and one utterances a block, the block instance shared (S = 33,
# 150) and global (S = 150 forced, 300), short chunks
GAMMA_CASES = [(18, None), (18, ("warp", 16, 4)), (18, ("warp", 16, 2)), (30, None), (30, ("warp", 16, 1)),
               (32, ("warp", 8, 3)), (33, None), (150, None), (150, ("global", 16, 1)), (150, ("shared", 4, 1)), (300, None),
               (300, ("global", 1, 1))]


@pytest.mark.parametrize("case", GAMMA_CASES, ids=lambda c: "S%d_%s" % (c[0], "_".join(map(str, c[1] or ("own",)))))
def test_gamma_dense_instances_match_plain_version(device, monkeypatch, case):
    """K7, and K15 with square and non-square rows × cols, in the instance
    each S takes or a forced one, against their plain versions (γ abs 1e-5,
    ξ rel 1e-4): lengths 0, 1, C − 1, C, C + 1, across chunks and ragged;
    γ = 0 past each end; two calls agree bitwise."""
    s, forced = case
    if forced is not None:
        monkeypatch.setattr(cuda_scan, "gamma_instance", lambda *args: forced[:2])
        monkeypatch.setattr(cuda_scan, "gamma_utterances", lambda *args: forced[2])
    chunk = (forced or cuda_scan.gamma_instance(s))[1]
    lengths = _chunk_lengths(chunk, 3 * chunk + 5)
    a = dense_args(dense_problem(70 + s, s, 4, len(lengths), max(lengths), lengths=np.array(lengths)),
                   torch.float32, device)
    f = cuda_scan.forward_llh_dense_plain(a["llh"], a["lens"], a["trans"], a["init"])
    est = (a["llh"], a["lens"], a["trans"], a["final"], f[0], f[1])
    rng = np.random.default_rng(s)
    ids = torch.arange(s, device=device, dtype=torch.int32)
    blocks = [{}, dict(rows=ids[::3].contiguous(), cols=ids[::3].contiguous()),
              dict(rows=t(np.sort(rng.choice(s, size=max(s // 3, 1), replace=False)), torch.int32).to(device),
                   cols=t(rng.permutation(s)[: max(s // 2, 1)], torch.int32).to(device))]
    cuda_scan.reset_launch_counts()
    for kw in blocks:
        got = cuda_scan.estep_gamma_dense(*est, **kw)
        want = cuda_scan.estep_gamma_dense_plain(*est, **kw)
        torch.cuda.synchronize()
        assert float((got[0] - want[0]).abs().max()) <= 1e-5
        assert got[1].shape == want[1].shape and _rel(got[1], want[1]) <= 1e-4
        for b, ln in enumerate(lengths):
            assert not got[0][b, ln:].any()
        for x, y in zip(got, cuda_scan.estep_gamma_dense(*est, **kw)):
            assert torch.equal(x, y)
    assert _launched() == {"estep_gamma_dense": 2, "estep_gamma_dense_restricted": 4}


# (units, states per unit, P, forced (placement, utterances a block, frames a
# chunk)): the geometries forward_banded_geometry picks at config 4 (50
# units, B = 514: shared, 2), config 5 (10 units, P = 32, B = 258: shared,
# 1), 100 and 250 units (B = 64: shared, 1 and global, 1), the ones the
# rule by fit alone picked there, and others
FORWARD_BANDED_CASES = [(50, 3, 78, ("shared", 2, 16)), (10, 3, 32, ("shared", 1, 16)),
                        (100, 3, 78, ("shared", 1, 16)), (250, 3, 78, ("global", 1, 16)),
                        (50, 3, 78, ("global", 4, 16)), (10, 3, 32, ("shared", 4, 16)),
                        (100, 3, 78, ("global", 2, 16)), (50, 3, 78, ("shared", 1, 8)), (50, 3, 78, ("global", 3, 1)),
                        (1, 1, 5, ("shared", 4, 2)), (11, 3, 6, ("global", 2, 4))]


@pytest.mark.parametrize("case", FORWARD_BANDED_CASES, ids=lambda c: "U%d_P%d_%s_u%d_c%d" % (c[0], c[2], *c[3]))
def test_forward_banded_geometries_match_plain_version(device, monkeypatch, case):
    """K1 in each launch geometry (forced), against its plain version (log Z
    rel 1e-5, α̂ and last abs 1e-5, norms rel 1e-5): lengths 0, 1, C − 1, C,
    C + 1, across chunks and ragged, a block of utterances the batch does
    not fill; α̂ = 0 and norm = 1 past each end, last = init and log Z = 0
    on an empty row; two calls agree bitwise."""
    units, spu, p_dim, geometry = case
    chunk = geometry[2]
    lengths = _chunk_lengths(chunk, 3 * chunk + 5)[: 7 if geometry[1] == 4 else 8]
    a = port_args(scan_problem(units + chunk, units, spu, p_dim, len(lengths), max(lengths), lengths=lengths),
                  torch.float32, device)
    fwd = (a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["init"])
    monkeypatch.setattr(cuda_scan, "forward_banded_geometry", lambda *args: geometry)
    cuda_scan.reset_launch_counts()
    got = cuda_scan.forward_llh_banded(*fwd)
    want = cuda_scan.forward_llh_banded_plain(*fwd)
    torch.cuda.synchronize()
    full = a["lens"] > 0
    assert _rel(got[3][full], want[3][full]) <= 1e-5 and not got[3][~full].any()
    assert float((got[0] - want[0]).abs().max()) <= 1e-5 and float((got[2] - want[2]).abs().max()) <= 1e-5
    assert _rel(got[1], want[1]) <= 1e-5
    assert torch.equal(got[2][~full], a["init"].expand(int((~full).sum()), -1))
    for b, ln in enumerate(lengths):
        assert not got[0][b, ln:].any() and (got[1][b, ln:] == 1).all()
    for x, y in zip(got, cuda_scan.forward_llh_banded(*fwd)):
        assert torch.equal(x, y)
    assert _launched() == {"forward_llh_banded": 2}


# ----------------------------------------------------------------------
# K11 (B7's banded mode) on the chunked backward, K3 (B3) on K1's skeleton
# ----------------------------------------------------------------------
# (units, states per unit, P, forced (placement, utterances a block, frames
# a chunk)): the geometries gamma_banded_geometry picks at config 4 (50
# units, B = 514: global, 2), config 5 (10 units, P = 32, B = 258: shared,
# 1), 100 units (B = 64: shared, 1) and 250 units (global, 1), and others
GAMMA_BANDED_CASES = [(50, 3, 78, ("global", 2, 16)), (10, 3, 32, ("shared", 1, 16)),
                      (100, 3, 78, ("shared", 1, 16)), (250, 3, 78, ("global", 1, 16)),
                      (50, 3, 78, ("shared", 1, 16)), (10, 3, 32, ("shared", 4, 16)),
                      (50, 3, 78, ("global", 3, 1)), (50, 3, 78, ("shared", 2, 8)), (1, 1, 5, ("shared", 4, 2)),
                      (11, 3, 6, ("global", 2, 4))]


@pytest.mark.parametrize("case", GAMMA_BANDED_CASES, ids=lambda c: "U%d_P%d_%s_u%d_c%d" % (c[0], c[2], *c[3]))
def test_gamma_banded_geometries_match_plain_version(device, monkeypatch, case):
    """K11 in each launch geometry (forced), against its plain version (γ
    and γ₀ abs 1e-5, ξ rel 1e-4): lengths 0, 1, C − 1, C, C + 1, across
    chunks and ragged, a block of utterances the batch does not fill; γ = 0
    past each end and γ₀ = 0 on an empty row; two calls agree bitwise."""
    units, spu, p_dim, geometry = case
    chunk = geometry[2]
    lengths = _chunk_lengths(chunk, 3 * chunk + 5)[: 7 if geometry[1] == 4 else 8]
    a = port_args(scan_problem(units + chunk, units, spu, p_dim, len(lengths), max(lengths), lengths=lengths),
                  torch.float32, device)
    fwd = (a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["init"])
    alpha, norms, _, _ = cuda_scan.forward_llh_banded_plain(*fwd)
    est = (a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["final"], alpha, norms, a["ends"], a["starts"])
    monkeypatch.setattr(cuda_scan, "gamma_banded_geometry", lambda *args: geometry)
    cuda_scan.reset_launch_counts()
    got = cuda_scan.estep_gamma_banded(*est)
    want = cuda_scan.estep_gamma_banded_plain(*est)
    torch.cuda.synchronize()
    assert float((got[0] - want[0]).abs().max()) <= 1e-5 and float((got[1] - want[1]).abs().max()) <= 1e-5
    assert _rel(got[2], want[2]) <= 1e-4
    for b, ln in enumerate(lengths):
        assert not got[0][b, ln:].any()
    assert not got[1][a["lens"] == 0].any()
    for x, y in zip(got, cuda_scan.estep_gamma_banded(*est)):
        assert torch.equal(x, y)
    assert _launched() == {"estep_gamma_banded": 2}


def test_gamma_banded_takes_a_peaked_llh(device):
    """K11 on long utterances whose llh spreads four times wider than the
    other cases' (W scaled by 4), so that Σv of a frame falls far below 1:
    the normalised carry holds its plain version at the usual tolerances."""
    pb = scan_problem(31, 10, 3, 32, 4, 250, lengths=[250, 249, 17, 0])
    pb["w"] = pb["w"] * 4.0
    a = port_args(pb, torch.float32, device)
    fwd = (a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["init"])
    alpha, norms, _, _ = cuda_scan.forward_llh_banded_plain(*fwd)
    est = (a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["final"], alpha, norms, a["ends"], a["starts"])
    got = cuda_scan.estep_gamma_banded(*est)
    want = cuda_scan.estep_gamma_banded_plain(*est)
    torch.cuda.synchronize()
    assert float((got[0] - want[0]).abs().max()) <= 1e-5 and float((got[1] - want[1]).abs().max()) <= 1e-5
    assert _rel(got[2], want[2]) <= 1e-4


def _viterbi_close(got, want, lf, lens):
    """K3 equals its plain version (choices, exit indices, α_last); the
    backtrace on its outputs gives the plain route's paths and scores."""
    for name, x, y in zip(("choices", "exarg", "alpha_last"), got, want):
        assert torch.equal(x, y), name
    paths, scores = cuda_scan.viterbi_backtrace_banded_plain(*got, lf)
    paths_r, scores_r = cuda_scan.viterbi_backtrace_banded_plain(*want, lf)
    full = lens > 0
    assert _rel(scores[full], scores_r[full]) <= 1e-6
    valid = torch.arange(paths.shape[1], device=paths.device)[None] < lens[:, None]
    if bool(valid.any()):
        assert float((paths == paths_r)[valid].float().mean()) >= 0.999


# (units, states per unit, forced (placement, utterances a block, frames a
# chunk)): the geometries viterbi_banded_geometry picks at config 4 (50 × 3,
# B = 514: shared, 2), config 5 (10 × 3, B = 256: shared, 1), config 3's S
# = 18 and near the limit of the per-frame kernel (S = 9,600: global, one
# frame a chunk, the block chain), and others: the warp chain at S = 192
# (its last register), the block chain at S = 1,100 and 2,100
VITERBI_CASES = [(50, 3, ("shared", 2, 16)), (10, 3, ("shared", 1, 16)), (6, 3, ("shared", 1, 16)),
                 (3200, 3, ("global", 1, 1)), (50, 3, ("global", 4, 16)), (50, 3, ("shared", 3, 1)),
                 (10, 3, ("shared", 4, 8)), (1, 1, ("shared", 4, 2)), (100, 11, ("global", 1, 4)),
                 (64, 3, ("shared", 2, 16)), (700, 3, ("shared", 1, 4)), (700, 3, ("global", 1, 4))]


@pytest.mark.parametrize("case", VITERBI_CASES, ids=lambda c: "U%d_S%d_%s_u%d_c%d" % (c[0], c[0] * c[1], *c[2]))
def test_viterbi_banded_geometries_match_plain_version(device, monkeypatch, case):
    """K3 in each launch geometry (forced), against its plain version:
    choices, exit indices and α_last equal, lengths 0, 1, C − 1, C, C + 1,
    across chunks and ragged, a block the batch does not fill; choice 0 and
    exit 0 past each end; two calls agree bitwise."""
    units, spu, geometry = case
    chunk = geometry[2]
    lengths = _chunk_lengths(chunk, 3 * chunk + 5)[: 7 if geometry[1] == 4 else 8]
    a = port_args(scan_problem(units + 3 * chunk, units, spu, 6, len(lengths), max(lengths), lengths=lengths),
                  torch.float32, device)
    llh = (a["stats"] @ a["w"].T + a["bias"]).contiguous()
    vit = (llh, a["lens"], tss.log_bands(a["bands"]).contiguous(), tss.log_bands(a["init"]).contiguous())
    monkeypatch.setattr(cuda_scan, "viterbi_banded_geometry", lambda *args: geometry)
    cuda_scan.reset_launch_counts()
    got = cuda_scan.viterbi_fwd_banded(*vit)
    want = cuda_scan.viterbi_fwd_banded_plain(*vit)
    torch.cuda.synchronize()
    _viterbi_close(got, want, tss.log_bands(a["final"]).contiguous(), a["lens"])
    for b, ln in enumerate(lengths):
        assert not got[0][b, max(ln, 1):].any() and not got[1][b, max(ln, 1):].any()
    for x, y in zip(got, cuda_scan.viterbi_fwd_banded(*vit)):
        assert torch.equal(x, y)
    assert _launched() == {"viterbi_fwd_banded": 2}


def test_viterbi_banded_short_batches_and_the_loop(device):
    """K3 at T = 0 (α_last = log_init), T = 1 (frame 0 alone, every row),
    and on a loop of one-state units whose best path must take the loop at
    frame 1 (choice 2, the exit index of frame 0's best end)."""
    for t_len in (0, 1):
        a = port_args(scan_problem(3, 4, 3, 6, 3, max(t_len, 1), lengths=[t_len, 0, t_len]), torch.float32, device)
        llh = (a["stats"] @ a["w"].T + a["bias"])[:, :t_len].contiguous()
        vit = (llh, a["lens"], tss.log_bands(a["bands"]).contiguous(), tss.log_bands(a["init"]).contiguous())
        got = cuda_scan.viterbi_fwd_banded(*vit)
        want = cuda_scan.viterbi_fwd_banded_plain(*vit)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    a = port_args(scan_problem(4, 5, 1, 6, 2, 2, lengths=[2, 2]), torch.float32, device)
    llh = torch.full((2, 2, 5), -50.0, device=device)
    llh[:, 0, 0] = 0.0
    llh[:, 1, 3] = 0.0
    lb = tss.log_bands(a["bands"]).contiguous()
    vit = (llh, a["lens"], lb, tss.log_bands(a["init"]).contiguous())
    got = cuda_scan.viterbi_fwd_banded(*vit)
    want = cuda_scan.viterbi_fwd_banded_plain(*vit)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert int(got[0][0, 1, 3]) == 2 and int(got[1][0, 1]) == 0
    paths, _ = cuda_scan.viterbi_backtrace_banded(*got, tss.log_bands(a["final"]).contiguous())
    assert paths[0].tolist() == [0, 3]


def test_gamma_dense_at_the_parents_global_limit(device):
    """K7 at S = 9,674, the largest S its per-frame kernel took (the global
    block at a one-frame chunk keeps one ring stage to fit), on a short
    batch against its plain version (γ abs 1e-5, ξ rel 1e-4)."""
    s = 9674
    assert cuda_scan.gamma_instance(s) == ("global", 1)
    rng = np.random.default_rng(9674)
    lengths = [4, 1, 0]
    b, t_len = len(lengths), max(lengths)
    trans = torch.rand(s, s, generator=torch.Generator(device=device).manual_seed(0), device=device)
    trans = trans * (trans > 0.3) * (0.9 / s)
    init = torch.from_numpy(rng.dirichlet(np.ones(s), size=b)).float().to(device)
    final = torch.from_numpy(rng.uniform(0.05, 0.5, size=(b, s))).float().to(device)
    llh = torch.from_numpy(rng.normal(size=(b, t_len, s))).float().to(device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    f = cuda_scan.forward_llh_dense_plain(llh, lens, trans, init)
    est = (llh, lens, trans, final, f[0], f[1])
    cuda_scan.reset_launch_counts()
    got = cuda_scan.estep_gamma_dense(*est)
    want = cuda_scan.estep_gamma_dense_plain(*est)
    torch.cuda.synchronize()
    assert float((got[0] - want[0]).abs().max()) <= 1e-5 and _rel(got[1], want[1]) <= 1e-4
    assert _launched() == {"estep_gamma_dense": 1}


# ----------------------------------------------------------------------
# K4: one warp an utterance over staged choices; K13 banded in chunks
# ----------------------------------------------------------------------
def _backtrace_operands(device, s, lengths, seed, per_row=False, t_len=None):
    """K4's operands at S states: random choices with many exits (choice 2
    on 30 % of the valid frames, 0 past each end as K3 writes them), random
    exit indices, α_last and log_final rounded to halves so that the final
    arg-max meets ties, log_final (S,) or per row (B, S)."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    t_len = max(lengths) if t_len is None else t_len
    choices = rng.choice(3, size=(b, t_len, s), p=[0.4, 0.3, 0.3]).astype(np.int8)
    exarg = rng.integers(0, s, size=(b, t_len)).astype(np.int32)
    for i, ln in enumerate(lengths):
        choices[i, max(ln, 1):] = 0
        exarg[i, max(ln, 1):] = 0
    choices[:, :1] = 0
    exarg[:, :1] = 0
    alpha = np.round(rng.normal(size=(b, s)) * 2) / 2
    lf = np.round(rng.normal(size=(b, s) if per_row else (s,)) * 2) / 2
    f = lambda x, dt: torch.from_numpy(x).to(device=device, dtype=dt).contiguous()  # noqa: E731
    return f(choices, torch.int8), f(exarg, torch.int32), f(alpha, torch.float32), f(lf, torch.float32)


def _backtrace_equal(back):
    got = cuda_scan.viterbi_backtrace_banded(*back)
    want = cuda_scan.viterbi_backtrace_banded_plain(*back)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]), "paths"
    assert torch.equal(got[1], want[1]), "scores"
    return got


# (S, forced (instance, utterances a block, frames a chunk), log_final per row):
# the geometries backtrace_banded_geometry picks (staged, one utterance,
# 16 frames; direct above S = 1,024), several utterances a block and a block
# the batch does not fill, chunks of 8, 4, 2 and 1 frames (staged to S =
# 16,564), and the direct chase at small S; S = 1, below, at and above a
# warp's 32 lanes and K3's warp chain (192), and large
BACKTRACE_CASES = [(150, ("staged", 1, 16), False), (18, ("staged", 1, 16), True), (30, ("staged", 4, 16), False),
                   (33, ("staged", 3, 8), True), (32, ("staged", 2, 2), False), (1, ("staged", 4, 1), False),
                   (192, ("staged", 1, 4), True), (193, ("staged", 4, 16), False), (1000, ("staged", 2, 1), False),
                   (9600, ("staged", 1, 4), False), (16564, ("staged", 1, 2), True), (150, ("direct", 1, 32), True),
                   (31, ("direct", 4, 32), False), (300, ("direct", 3, 32), True), (2100, ("direct", 1, 32), False)]


@pytest.mark.parametrize("case", BACKTRACE_CASES, ids=lambda c: "S%d_%s_u%d_c%d_%s" % (c[0], *c[1], "rows" if c[2] else "one"))
def test_backtrace_banded_geometries_match_plain_version(device, monkeypatch, case):
    """K4 in each launch geometry (forced), equal to its plain version
    (paths and scores): lengths 0, 1, C − 1, C, C + 1, several chunks and a
    ragged end, many exits, ties in the final arg-max, per-row log_final."""
    s, geometry, per_row = case
    chunk = geometry[2]
    lengths = _chunk_lengths(chunk, 3 * chunk + 5)[: 7 if geometry[1] == 4 else 8]
    back = _backtrace_operands(device, s, lengths, s + chunk, per_row)
    monkeypatch.setattr(cuda_scan, "backtrace_banded_geometry", lambda *args: geometry)
    cuda_scan.reset_launch_counts()
    _backtrace_equal(back)
    assert _launched() == {"viterbi_backtrace_banded": 1}


def test_backtrace_banded_edges(device):
    """K4 at T = 0 (the scores alone), on a batch of zero-length rows, on
    choices that start at an address that is not 16-byte aligned (a view
    past the first utterance), at K3's largest S (16,564) and at S = 60,000
    (the direct chase), each in the geometry its wrapper picks; and on K3's
    outputs for a phone loop of config 4's size, per-row log_final
    included."""
    for lengths, t_len in (([0, 0, 0], 0), ([0, 0, 0], 5), ([3, 1, 0, 9], 9)):
        _backtrace_equal(_backtrace_operands(device, 37, lengths, 1, t_len=t_len))
    ch, ex, al, lf = _backtrace_operands(device, 37, [9, 9, 5, 1, 0], 2)
    assert ch[1:].data_ptr() % 16 != 0
    _backtrace_equal((ch[1:], ex[1:], al[1:].contiguous(), lf))
    for s, want in ((16564, ("direct", 1, cuda_scan.BT_DIRECT_CHUNK)), (60000, ("direct", 1, cuda_scan.BT_DIRECT_CHUNK))):
        assert cuda_scan.backtrace_banded_geometry(s, 3, cuda_scan.sm_count(device.index)) == want
        _backtrace_equal(_backtrace_operands(device, s, [9, 4, 0], s))
    a = port_args(scan_problem(11, 50, 3, 78, 9, 70), torch.float32, device)
    llh = (a["stats"] @ a["w"].T + a["bias"]).contiguous()
    vit = cuda_scan.viterbi_fwd_banded(llh, a["lens"], tss.log_bands(a["bands"]).contiguous(),
                                       tss.log_bands(a["init"]).contiguous())
    lf = tss.log_bands(a["final"]).contiguous()
    _backtrace_equal((*vit, lf))
    _backtrace_equal((*vit, lf.expand(9, -1).contiguous()))


def _smoothing_contract(got, mask):
    """K13's frames t >= len: γ = 0, ŵ = 0, w_sums = post_norm = 1."""
    off = mask == 0
    assert not got[0][off].any() and not got[1][off].any()
    assert bool((got[2][off] == 1).all() and (got[3][off] == 1).all())


# (units, states per unit, forced (placement, utterances a block, frames a
# chunk)): the geometries smoothing_banded_geometry picks at config 4 (50 ×
# 3, B = 514: shared, 2, 8), config 5 (shared, 1, 16) and S = 450 (the
# block chain: shared, 1, 4), and others: the warp chain at S = 192 (its
# last register) and with the bands in device memory, a block the batch
# does not fill, one-frame chunks; the block chain at S = 195, 450 with the
# bands in device memory, and 1,100 (its 24 chain warps)
SMOOTHING_CASES = [(50, 3, ("shared", 2, 8)), (10, 3, ("shared", 1, 16)), (150, 3, ("shared", 1, 4)),
                   (64, 3, ("shared", 2, 8)), (50, 3, ("global", 4, 4)), (10, 3, ("shared", 3, 1)),
                   (1, 1, ("shared", 4, 2)), (11, 3, ("global", 2, 8)), (65, 3, ("shared", 1, 16)),
                   (150, 3, ("global", 1, 8)), (100, 11, ("shared", 1, 2)), (100, 11, ("global", 1, 1)),
                   (50, 3, ("shared", 2, 16))]


@pytest.mark.parametrize("case", SMOOTHING_CASES, ids=lambda c: "U%d_S%d_%s_u%d_c%d" % (c[0], c[0] * c[1], *c[2]))
def test_smoothing_banded_geometries_match_plain_version(device, monkeypatch, case):
    """K13 banded in each launch geometry (forced), against its plain
    version (γ and ŵ abs 1e-5, w_sums and post_norm rel 1e-5 on the valid
    frames; lengths 0, 1, C − 1, C, C + 1, across chunks and ragged) and its
    contract on the frames t >= len; two calls agree bitwise."""
    units, spu, geometry = case
    chunk = geometry[2]
    lengths = _chunk_lengths(chunk, 3 * chunk + 5)[: 7 if geometry[1] == 4 else 8]
    a = port_args(scan_problem(units + chunk, units, spu, 6, len(lengths), max(lengths), lengths=lengths),
                  torch.float32, device)
    llh = (a["stats"] @ a["w"].T + a["bias"]).contiguous()
    e, mask = _e_llh(llh, a["lens"])
    init, final = (a[k].expand(len(lengths), -1).contiguous() for k in ("init", "final"))
    monkeypatch.setattr(cuda_scan, "smoothing_banded_geometry", lambda *args: geometry)
    cuda_scan.reset_launch_counts()
    probs, _, got = _general_compare(e, a["lens"], mask, a["bands"], init, final, banded=True)
    _smoothing_contract(got, mask)
    smo = (e, probs, a["lens"], a["bands"], final)
    for x, y in zip(got, cuda_scan.smoothing_pass(*smo, banded=True)):
        assert torch.equal(x, y)
    assert _launched() == {"scaled_pass": 1, "smoothing_pass": 2}


def test_smoothing_banded_underflow_matches_plain_version(device, monkeypatch):
    """On the untrained loop whose α̂·u1 underflows (``port_util.
    underflow_problem``, ROADMAP §C.1), K13 banded gives γ = 0 on the frames
    where its plain version does and agrees elsewhere, in its own geometry
    and in the block chain's.  Neither flushes subnormals on the card, so
    fewer frames reach 0 than on a CPU that flushes (3 of 440 here, 86
    there); several more keep post_norm below FLT_MIN, where γ = ab /
    FLT_MIN."""
    pb = underflow_problem()
    f = lambda k: torch.from_numpy(np.asarray(pb[k])).to(device=device, dtype=torch.float32).contiguous()  # noqa: E731
    e, bands, init, final, mask = f("e_llh"), f("bands"), f("init"), f("final"), f("mask")
    lens = torch.from_numpy(pb["lengths"]).to(device=device, dtype=torch.int32)
    probs, _ = cuda_scan.scaled_pass_plain(e, lens, bands, init, banded=True)
    want = cuda_scan.smoothing_pass_plain(e, probs, lens, bands, final, banded=True)
    zero = (want[0].sum(-1) == 0) & (mask > 0)
    assert int(zero.sum()) > 0 and int(((want[3] < 1.1754944e-38) & (mask > 0)).sum()) > int(zero.sum()), \
        "the case must underflow"
    for geometry in (None, ("shared", 1, 16), ("global", 1, 1)):
        if geometry is not None:
            monkeypatch.setattr(cuda_scan, "smoothing_banded_geometry", lambda *args: geometry)
        got = cuda_scan.smoothing_pass(e, probs, lens, bands, final, banded=True)
        torch.cuda.synchronize()
        assert torch.equal((got[0].sum(-1) == 0) & (mask > 0), zero)
        _valid_close(got[0], want[0], mask, 1e-5, "gamma")
        _valid_close(got[1], want[1], mask, 1e-5, "w_probs")
        for name, x, y in (("w_sums", got[2], want[2]), ("post_norm", got[3], want[3])):
            _valid_close(x, y, mask, 1e-5 * float((y * mask).max().clamp_min(1.0)), name)
        _smoothing_contract(got, mask)


@pytest.mark.parametrize("units, spu", [(6449, 1), (2411, 3)], ids=["S6449", "S7233"])
def test_smoothing_banded_at_its_limits(device, units, spu):
    """K13 banded at S = 6,449, the largest S its per-frame kernel took, and
    at 7,233, near the chunked kernel's own limit (7,234) (the bands in device memory,
    one-frame chunks), on a short batch against its plain version."""
    s = units * spu
    assert cuda_scan.smoothing_banded_geometry(s, 3, cuda_scan.sm_count(device.index)) == ("global", 1, 1)
    a = port_args(scan_problem(s, units, spu, 4, 3, 5, lengths=[5, 1, 0]), torch.float32, device)
    llh = (a["stats"] @ a["w"].T + a["bias"]).contiguous()
    e, mask = _e_llh(llh, a["lens"])
    init, final = (a[k].expand(3, -1).contiguous() for k in ("init", "final"))
    probs, _ = cuda_scan.scaled_pass_plain(e, a["lens"], a["bands"], init, banded=True)
    got = cuda_scan.smoothing_pass(e, probs, a["lens"], a["bands"], final, banded=True)
    want = cuda_scan.smoothing_pass_plain(e, probs, a["lens"], a["bands"], final, banded=True)
    torch.cuda.synchronize()
    _valid_close(got[0], want[0], mask, 1e-5, "gamma")
    _valid_close(got[1], want[1], mask, 1e-5, "w_probs")
    for name, x, y in (("w_sums", got[2], want[2]), ("post_norm", got[3], want[3])):
        _valid_close(x, y, mask, 1e-5 * float((y * mask).max().clamp_min(1.0)), name)
    _smoothing_contract(got, mask)


def test_backtrace_and_banded_smoothing_refuse_grad(device):
    """Neither K4 nor K13 banded runs on inputs that require grad."""
    ch, ex, al, lf = _backtrace_operands(device, 30, [9, 4], 3)
    with pytest.raises(RuntimeError, match="requires grad"):
        cuda_scan.viterbi_backtrace_banded(ch, ex, al.requires_grad_(), lf)
    a = port_args(scan_problem(3, 10, 3, 6, 2, 9), torch.float32, device)
    llh = (a["stats"] @ a["w"].T + a["bias"]).contiguous()
    e, _ = _e_llh(llh, a["lens"])
    init, final = (a[k].expand(2, -1).contiguous() for k in ("init", "final"))
    probs, _ = cuda_scan.scaled_pass(e, a["lens"], a["bands"], init, banded=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        cuda_scan.smoothing_pass(e.requires_grad_(), probs, a["lens"], a["bands"], final, banded=True)


# K12's banded forward in forced geometries (units, states per unit,
# (placement, utterances a block, frames a chunk)): what
# scaled_banded_geometry picks at config 4 (50 × 3, B = 514: shared, 2, 16),
# config 5 (shared, 1, 16) and S = 450 (the block chain: shared, 1, 16), and
# others: the warp chain at S = 192 (its last register), with the bands in
# device memory, four utterances a block, one-frame chunks; the block chain
# with the bands in device memory, at S = 195 and 1,100 (its 8 chain warps
# of 64 states)
SCALED_BANDED_CASES = [(50, 3, ("shared", 2, 16)), (10, 3, ("shared", 1, 16)), (150, 3, ("shared", 1, 16)),
                       (64, 3, ("shared", 2, 8)), (50, 3, ("global", 4, 4)), (10, 3, ("shared", 3, 1)),
                       (1, 1, ("shared", 4, 2)), (11, 3, ("global", 2, 8)), (65, 3, ("shared", 1, 16)),
                       (150, 3, ("global", 1, 8)), (100, 11, ("shared", 1, 2)), (100, 11, ("global", 1, 1))]


@pytest.mark.parametrize("case", SCALED_BANDED_CASES, ids=lambda c: "U%d_S%d_%s_u%d_c%d" % (c[0], c[0] * c[1], *c[2]))
def test_scaled_banded_geometries_match_plain_version(device, monkeypatch, case):
    """K12 banded in each launch geometry (forced), against its plain
    version (α̂ abs 1e-5, logcs rel 1e-5 over every frame, the copied ones
    included; lengths 0, 1, C − 1, C, C + 1, across chunks and ragged); two
    calls agree bitwise."""
    units, spu, geometry = case
    chunk = geometry[2]
    lengths = _chunk_lengths(chunk, 3 * chunk + 5)[: 7 if geometry[1] == 4 else 8]
    a = port_args(scan_problem(units + chunk, units, spu, 6, len(lengths), max(lengths), lengths=lengths),
                  torch.float32, device)
    llh = (a["stats"] @ a["w"].T + a["bias"]).contiguous()
    e, mask = _e_llh(llh, a["lens"])
    init = a["init"].expand(len(lengths), -1).contiguous()
    monkeypatch.setattr(cuda_scan, "scaled_banded_geometry", lambda *args: geometry)
    cuda_scan.reset_launch_counts()
    fwd = (e, a["lens"], a["bands"], init)
    got = cuda_scan.scaled_pass(*fwd, banded=True)
    want = cuda_scan.scaled_pass_plain(*fwd, banded=True)
    torch.cuda.synchronize()
    assert float((got[0] - want[0]).abs().max()) <= 1e-5
    assert float((got[1] - want[1]).abs().max() / want[1].abs().max().clamp_min(1.0)) <= 1e-5
    for x, y in zip(got, cuda_scan.scaled_pass(*fwd, banded=True)):
        assert torch.equal(x, y)
    assert _launched() == {"scaled_pass": 2}


# The dense instances of K12 and K13 in forced geometries (S, (placement,
# utterances a block, slices)): what dense_grouped_geometry picks at config
# 4's matrix (shared, 2, 6), config 5's loop (shared, 1, 8) and S = 300 / 450
# (global, 1, 3 / 4, 2), and others: every utterance count in both
# placements (the global one with some of M's rows from device memory at S
# = 300, 450), one slice at small S, the most slices, S = 1
GROUPED_CASES = [(150, ("shared", 2, 6)), (30, ("shared", 1, 8)), (300, ("global", 1, 3)), (450, ("global", 4, 2)),
                 (150, ("shared", 4, 6)), (30, ("shared", 2, 8)),
                 (150, ("shared", 8, 6)), (150, ("global", 2, 6)), (45, ("shared", 1, 1)), (45, ("global", 8, 8)),
                 (450, ("global", 8, 2)),
                 (7, ("shared", 4, 7)), (1, ("global", 2, 1)), (236, ("shared", 1, 4)), (238, ("global", 4, 4))]


@pytest.mark.parametrize("case", GROUPED_CASES, ids=lambda c: "S%d_%s_u%d_k%d" % (c[0], *c[1]))
@pytest.mark.parametrize("grouping", ["sorted", "consecutive"])
def test_dense_grouped_geometries_match_plain_version(device, monkeypatch, case, grouping):
    """K12's dense forward and reverse and K13's dense instance in each
    launch geometry (forced) and with the rows grouped by length or as they
    come, against their plain versions (α̂, β̂, γ, ŵ abs 1e-5; logcs, w_sums,
    post_norm rel 1e-5; lengths 0, 1, C − 1, C, C + 1 and ragged, B not a
    multiple of the group), K13's contract on frames t >= len; two calls
    agree bitwise."""
    s, geometry = case
    lengths = _chunk_lengths(4, 21)[:7] + [9, 21]
    a = dense_args(dense_problem(s + 1, s, 4, len(lengths), 21, np.array(lengths)), torch.float32, device)
    e, mask = _e_llh(a["llh"], a["lens"])
    monkeypatch.setattr(cuda_scan, "dense_grouped_geometry", lambda *args: geometry)
    if grouping == "consecutive":
        monkeypatch.setattr(cuda_scan, "group_order",
                            lambda lens: torch.arange(lens.shape[0], dtype=torch.int32, device=lens.device))
    cuda_scan.reset_launch_counts()
    probs, _, got = _general_compare(e, a["lens"], mask, a["trans"], a["init"], a["final"], banded=False)
    _smoothing_contract(got, mask)
    rev = (e, a["lens"], a["trans"], a["final"])
    beta, blog = cuda_scan.scaled_pass(*rev, reverse=True)
    beta_r, blog_r = cuda_scan.scaled_pass_plain(*rev, reverse=True)
    torch.cuda.synchronize()
    assert float((beta - beta_r).abs().max()) <= 1e-5
    assert float((blog - blog_r).abs().max() / blog_r.abs().max().clamp_min(1.0)) <= 1e-5
    smo = (e, probs, a["lens"], a["trans"], a["final"])
    for x, y in zip(got, cuda_scan.smoothing_pass(*smo)):
        assert torch.equal(x, y)
    for x, y in zip((beta, blog), cuda_scan.scaled_pass(*rev, reverse=True)):
        assert torch.equal(x, y)
    assert _launched() == {"scaled_pass": 3, "smoothing_pass": 2}


def test_general_kernels_underflow_as_their_plain_versions(device):
    """On the untrained loop whose α̂·u1 underflows (``port_util.
    underflow_problem``), K12's banded and dense forward keep the plain
    version's subnormal entries, and K13's dense instance gives γ = 0 on the
    frames where its plain version does and agrees elsewhere."""
    pb = underflow_problem()
    f = lambda k: torch.from_numpy(np.asarray(pb[k])).to(device=device, dtype=torch.float32).contiguous()  # noqa: E731
    e, bands, init, final, mask = f("e_llh"), f("bands"), f("init"), f("final"), f("mask")
    lens = torch.from_numpy(pb["lengths"]).to(device=device, dtype=torch.int32)
    dense = tss.bands_to_dense(bands).contiguous()
    tiny = 1.1754944e-38
    for mat, banded in ((bands, True), (dense, False)):
        got = cuda_scan.scaled_pass(e, lens, mat, init, banded=banded)
        want = cuda_scan.scaled_pass_plain(e, lens, mat, init, banded=banded)
        torch.cuda.synchronize()
        assert float((got[0] - want[0]).abs().max()) <= 1e-5
        assert float((got[1] - want[1]).abs().max() / want[1].abs().max().clamp_min(1.0)) <= 1e-5
        sub = lambda p: (p > 0) & (p < tiny)  # noqa: E731
        assert int(sub(want[0]).sum()) > 0 and torch.equal(sub(got[0]) | (got[0] == 0), sub(want[0]) | (want[0] == 0))
    probs, _ = cuda_scan.scaled_pass_plain(e, lens, dense, init)
    want = cuda_scan.smoothing_pass_plain(e, probs, lens, dense, final)
    zero = (want[0].sum(-1) == 0) & (mask > 0)
    assert int(zero.sum()) > 0, "the case must underflow"
    got = cuda_scan.smoothing_pass(e, probs, lens, dense, final)
    torch.cuda.synchronize()
    assert torch.equal((got[0].sum(-1) == 0) & (mask > 0), zero)
    _valid_close(got[0], want[0], mask, 1e-5, "gamma")
    _valid_close(got[1], want[1], mask, 1e-5, "w_probs")
    for name, x, y in (("w_sums", got[2], want[2]), ("post_norm", got[3], want[3])):
        _valid_close(x, y, mask, 1e-5 * float((y * mask).max().clamp_min(1.0)), name)
    _smoothing_contract(got, mask)


@pytest.mark.parametrize("kernel, s", [("scaled_pass", 29024), ("smoothing_pass", 11609), ("banded", 9674)])
def test_general_kernels_at_the_parents_limits(device, kernel, s):
    """The largest S each parent took: K12's dense forward and reverse at
    29,024 (global, (2S + 64) floats), K13's dense instance at 11,609
    (global, (5S + 64)) and K12's banded forward at 9,674 ((6S + 64); the
    bands now in device memory), on a short batch against the plain
    versions."""
    n_sm = cuda_scan.sm_count(device.index)
    rng = np.random.default_rng(s)
    lengths = np.array([3, 1, 0])
    lens = torch.from_numpy(lengths).to(device=device, dtype=torch.int32)
    mask = (torch.arange(3, device=device)[None] < lens[:, None]).float()
    e = torch.from_numpy(rng.uniform(0.01, 1.0, size=(3, 3, s)).astype(np.float32)).to(device)
    e = (e * mask[..., None] + (1 - mask[..., None])).contiguous()
    init = torch.from_numpy(rng.dirichlet(np.ones(s), size=3).astype(np.float32)).to(device)
    final = torch.from_numpy(rng.uniform(0.05, 0.5, size=(3, s)).astype(np.float32)).to(device)
    if kernel == "banded":
        assert cuda_scan.scaled_banded_geometry(s, 3, n_sm)[0] == "global"
        bands = port_args(scan_problem(s, s // 2, 2, 4, 3, 3), torch.float32, device)["bands"]
        got = cuda_scan.scaled_pass(e, lens, bands, init, banded=True)
        want = cuda_scan.scaled_pass_plain(e, lens, bands, init, banded=True)
        torch.cuda.synchronize()
        assert float((got[0] - want[0]).abs().max()) <= 1e-5
        assert float((got[1] - want[1]).abs().max() / want[1].abs().max().clamp_min(1.0)) <= 1e-5
        return
    assert cuda_scan.dense_grouped_geometry(kernel, s, 3, n_sm)[0] == "global"
    trans = torch.rand(s, s, device=device, generator=torch.Generator(device).manual_seed(s))
    trans = 0.9 * trans / trans.sum(-1, keepdim=True)
    if kernel == "scaled_pass":
        for vec, reverse in ((init, False), (final, True)):
            got = cuda_scan.scaled_pass(e, lens, trans, vec, reverse=reverse)
            want = cuda_scan.scaled_pass_plain(e, lens, trans, vec, reverse=reverse)
            torch.cuda.synchronize()
            assert float((got[0] - want[0]).abs().max()) <= 1e-5
            assert float((got[1] - want[1]).abs().max() / want[1].abs().max().clamp_min(1.0)) <= 1e-5
        return
    probs, _ = cuda_scan.scaled_pass_plain(e, lens, trans, init)
    got = cuda_scan.smoothing_pass(e, probs, lens, trans, final)
    want = cuda_scan.smoothing_pass_plain(e, probs, lens, trans, final)
    torch.cuda.synchronize()
    _valid_close(got[0], want[0], mask, 1e-5, "gamma")
    _valid_close(got[1], want[1], mask, 1e-5, "w_probs")
    for name, x, y in (("w_sums", got[2], want[2]), ("post_norm", got[3], want[3])):
        _valid_close(x, y, mask, 1e-5 * float((y * mask).max().clamp_min(1.0)), name)
    _smoothing_contract(got, mask)


# ----------------------------------------------------------------------
# The CLI's verbs on the card (the supervised recipe, map-reduce)
# ----------------------------------------------------------------------
def _cli_corpus(root, n_utts=12, dim=13, seed=0):
    """A labelled corpus of 3 phones (a Gaussian cluster each, 8–20
    frames a phone) as ``feats.npz``, ``train.trans`` and a mkphones
    config of 3 states × 2 components a phone."""
    rng = np.random.default_rng(seed)
    centres = {p: rng.normal(scale=3.0, size=dim) for p in "abc"}
    feats, lines = {}, []
    for i in range(n_utts):
        seq = list(rng.choice(list("abc"), size=int(rng.integers(2, 6))))
        feats[f"utt{i:02d}"] = np.concatenate([
            centres[p] + rng.normal(size=(int(rng.integers(8, 21)), dim)) for p in seq
        ]).astype(np.float32)
        lines.append(f"utt{i:02d} {' '.join(seq)}")
    np.savez(root / "feats.npz", **feats)
    (root / "train.trans").write_text("\n".join(lines) + "\n")
    (root / "phones.yml").write_text("states_per_phone: 3\nncomp_per_state: 2\n")
    (root / "hmm.yml").write_text("n_units: 4\nstates_per_unit: 3\n")
    return root


def _verb(argv):
    from beer_tpu_torch.cli.main import main as cli

    assert cli([str(a) for a in argv]) == 0, argv


def test_cli_supervised_verbs_on_the_card(device, tmp_path):
    """mkphones → train --transcriptions (K5 + K7) → align (K3 + K4) →
    decode --phone-lm on the card: the ELBO per frame within 1e-4 of the
    plain route's, the alignment equal to the plain route's, the phone-LM
    decode (the dense Viterbi in plain torch) equal to the same verb with
    ``--device cpu`` on every frame."""
    import contextlib
    import io
    import re

    from beer_tpu_torch import io as bio
    from beer_tpu_torch.utils import load_model

    r = _cli_corpus(tmp_path)
    _verb(["hmm", "mkphones", r / "phones.yml", r / "feats.npz", r / "train.trans", r / "em.mdl"])
    cuda_scan.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _verb(["hmm", "train", r / "em.mdl", r / "feats.npz", r / "exp", "--epochs", "3",
               "--transcriptions", r / "train.trans"])
    assert cuda_scan.KERNELS["forward_llh_dense"].launches == 3
    assert cuda_scan.KERNELS["estep_gamma_dense"].launches == 3
    got = [float(v) for v in re.findall(r"elbo/frame = (\S+)", out.getvalue())]

    keys, data, mask = bio.load_padded(r / "feats.npz")
    x, m = torch.from_numpy(data).to(device), torch.from_numpy(mask).to(device)
    phones = ["a", "b", "c"]
    trans = {line.split()[0]: line.split()[1:] for line in (r / "train.trans").read_text().splitlines()}
    graphs = bt.transcription_graphs([[phones.index(p) for p in trans[k]] for k in keys], 3, 3)
    twin = bt.HMM.create(graphs, load_model(r / "em.mdl"))
    twin.plain_scan = True
    plain = []
    for _ in range(3):
        elbo, twin = bt.vb_step(twin, x, mask=m)
        plain.append(elbo.item() / float(mask.sum()))
    assert max(abs(a - b) for a, b in zip(got, plain)) <= 1e-4, (got, plain)
    assert all(np.diff(got) >= -1e-6)

    cuda_scan.reset_launch_counts()
    _verb(["hmm", "align", r / "exp" / "final.mdl", r / "feats.npz", r / "train.trans", r / "ali.txt"])
    assert cuda_scan.KERNELS["viterbi_fwd_banded"].launches == 1
    assert cuda_scan.KERNELS["viterbi_backtrace_banded"].launches == 1
    hmm = bt.HMM.create(graphs, load_model(r / "exp" / "final.mdl"))
    hmm.plain_scan = True
    with torch.no_grad():
        paths, _ = hmm.decode(x, m)
    want = (torch.gather(graphs.pdf_ids, 1, paths.long()) // 3).cpu().numpy()
    for i, line in enumerate((r / "ali.txt").read_text().splitlines()):
        labels = [phones.index(p) for p in line.split()[1:]]
        assert labels == list(want[i, :int(mask[i].sum())]), keys[i]

    for dev in ("cuda", "cpu"):
        _verb(["hmm", "decode", r / "exp" / "final.mdl", r / "feats.npz", r / f"hyp_{dev}.txt",
               "--phone-lm", "--per-frame", "--lm-transcriptions", r / "train.trans",
               "--device", dev])
    card, cpu = ((r / f"hyp_{d}.txt").read_text().splitlines() for d in ("cuda", "cpu"))
    ties = sum(a != b for line_a, line_b in zip(card, cpu)
               for a, b in zip(line_a.split(), line_b.split()))
    assert ties == 0 and card == cpu


def test_cli_map_reduce_on_the_card_is_vb_step(device, tmp_path):
    """``hmm accumulate`` over 3 shards and ``hmm update`` on the card
    (K1 + K2) equal one full-batch ``vb_step`` on the card: every array
    within 2e-4 of its largest entry, the reduced ELBO within 1e-5 a
    frame."""
    import contextlib
    import io
    import re

    from beer_tpu_torch import io as bio
    from beer_tpu_torch.utils import load_model

    r = _cli_corpus(tmp_path)
    _verb(["hmm", "mkphoneloop", r / "hmm.yml", r / "feats.npz", r / "init.mdl"])
    cuda_scan.reset_launch_counts()
    for i in (1, 2, 3):
        _verb(["hmm", "accumulate", r / "init.mdl", r / "feats.npz", r / f"s{i}.acc",
               "--shard", f"{i}/3", "--batch-size", "2"])
    assert cuda_scan.KERNELS["forward_llh_banded"].launches == 6
    assert cuda_scan.KERNELS["estep_acc_banded"].launches == 6
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _verb(["hmm", "update", r / "init.mdl", r / "mr.mdl", r / "s1.acc", r / "s2.acc",
               r / "s3.acc"])
    reduced = float(re.search(r"elbo/frame = (\S+)", out.getvalue()).group(1))
    _, data, mask = bio.load_padded(r / "feats.npz")
    x, m = torch.from_numpy(data).to(device), torch.from_numpy(mask).to(device)
    elbo, full = bt.vb_step(load_model(r / "init.mdl"), x, mask=m)
    assert abs(reduced - elbo.item() / float(mask.sum())) <= 1e-5
    for (name, a), (_, b) in zip(load_model(r / "mr.mdl").state_dict().items(),
                                 full.state_dict().items()):
        assert _rel(a, b) <= 2e-4, name


# ----------------------------------------------------------------------
# PPCA and PLDA (configs 7 and 8 at a mid size): plain torch on the card
# ----------------------------------------------------------------------
def _subspace_data(kind):
    """PPCA: 20,000 frames of a 16-dim subspace in 128 dims (noise 0.1);
    PLDA: 256 classes × 32 embeddings, D = 128, Q = 16 (noise 0.3)."""
    rng = np.random.default_rng(11)
    d, q = 128, 16
    w = rng.normal(size=(d, q)) / np.sqrt(q)
    if kind == "ppca":
        x = rng.normal(size=(20_000, q)) @ w.T + 0.1 * rng.normal(size=(20_000, d))
        return x.astype(np.float32), None
    h = np.repeat(rng.normal(size=(256, q)), 32, 0)
    x = h @ w.T + 0.3 * rng.normal(size=h.shape[:1] + (d,))
    return x.astype(np.float32), np.repeat(np.arange(256), 32)


@pytest.mark.parametrize("kind", ["ppca", "plda"])
def test_subspace_models_on_the_card_match_float64_on_the_cpu(device, kind):
    """Three joint and three coordinate steps in float32 on the card beside
    a float64 copy on the CPU carried across at the start and run on its
    own, then one more E-step of each (so the last update shows): ELBOs
    within 1e-4 a frame; PLDA's per-class sums (one-hot products) and its
    ``infer`` are bitwise repeatable."""
    x, y = _subspace_data(kind)
    cls, conv = (bt.PPCA, bt.ppca_from_numpy) if kind == "ppca" else (bt.PLDA, bt.plda_from_numpy)
    model = cls.create(x.shape[1], 16, device=device, generator=torch.Generator().manual_seed(3))
    xc, x64 = torch.from_numpy(x).to(device), torch.from_numpy(x).double()
    kw_card = {} if y is None else {"labels": torch.from_numpy(y).to(device), "n_classes": 256}
    kw_cpu = {} if y is None else {"labels": torch.from_numpy(y), "n_classes": 256}
    ref = conv(model.to_numpy(), device="cpu", dtype=torch.float64)
    for i, step in enumerate([bt.vb_step] * 3 + [bt.vb_step_coordinate] * 3 + [bt.elbo_and_stats]):
        e_card = float(step(model, xc, **kw_card)[0])
        e_ref = float(step(ref, x64, **kw_cpu)[0])
        assert abs(e_card - e_ref) / len(x) <= 1e-4, (i, e_card, e_ref)
    if kind == "plda":
        a, cache_a = model.infer(xc, **kw_card)
        b, cache_b = model.infer(xc, **kw_card)
        assert torch.equal(a, b) and torch.equal(cache_a["m_h"], cache_b["m_h"])
        assert torch.equal(cache_a["counts"], torch.full_like(cache_a["counts"], 32.0))


def _gsm_problem(device, variant):
    """A small GSM (6 units × 3 states, D = 5, learned transitions; with
    ``trunk`` an MLP of 5 and 6) or HierarchicalGSM (3 languages × 4
    units) on the card, and unit
    statistics in ``accumulate_unit_stats``' dict layout (or, for
    ``array``, its emission array and counts)."""
    gen = torch.Generator().manual_seed(3)
    if variant == "hierarchical":
        gsm = bt.HierarchicalGSM.create(12, 3, 5, lang_dim=2, n_langs=3,
                                        unit_lang=[u // 4 for u in range(12)], states_per_unit=3,
                                        learn_transitions=True, generator=gen, device=device)
    else:
        gsm = bt.GSM.create(6, 3, 5, states_per_unit=3, learn_transitions=variant != "array",
                            trunk="mlp:5,6:tanh" if variant == "trunk" else None, generator=gen,
                            device=device)
    rng = np.random.default_rng(5)
    u = gsm.n_units
    c = rng.uniform(20.0, 80.0, size=(u, 3, 1))
    mu, var = rng.normal(size=(u, 3, 1, 5)), rng.uniform(0.5, 2.0, size=(u, 3, 1, 5))
    cc = c[..., None]
    emission = np.concatenate([-0.5 * cc * (var + mu**2), cc * mu,
                               np.broadcast_to(-0.5 * cc, mu.shape),
                               np.broadcast_to(0.5 * cc, mu.shape)], axis=-1)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).float().to(device)  # noqa: E731
    if variant == "array":
        return gsm, (to(emission[..., 0, :]), to(c[..., 0]))
    return gsm, ({"emission": to(emission), "comp_counts": to(c), "self": to(0.8 * c[..., 0]),
                  "adv": to(0.2 * c[..., 0])}, None)


def _gsm_eager(gsm, stats, counts, eps, n):
    g = copy.deepcopy(gsm)
    step = bt.make_gsm_train_step(torch.optim.Adam(g.parameters(), lr=5e-2, capturable=True))
    return torch.stack([step(g, stats, counts, eps={k: v[i] for k, v in eps.items()})
                        for i in range(n)]), g


@pytest.mark.parametrize("variant", ["plain", "array", "trunk", "hierarchical"])
def test_gsm_train_scan_graph_equals_the_eager_loop(device, variant):
    """``make_gsm_train_scan`` on the card (a CUDA graph) against the eager
    loop on the same noise from the same start: one call of 30 steps and 30
    one-step calls replaying one graph.  Bitwise where two eager runs are
    (the GSM), otherwise every step's ELBO within 1e-5 and the parameters
    within 1e-4 relative."""
    gsm, (stats, counts) = _gsm_problem(device, variant)
    n = 30
    gen = torch.Generator(device=device).manual_seed(7)
    eps = {k: torch.randn((n, *s), generator=gen, device=device)
           for k, s in gsm._eps_spec(4).items()}
    e1, m1 = _gsm_eager(gsm, stats, counts, eps, n)
    e2, m2 = _gsm_eager(gsm, stats, counts, eps, n)
    whole = copy.deepcopy(gsm)
    run = bt.make_gsm_train_scan(torch.optim.Adam(whole.parameters(), lr=5e-2, capturable=True))
    last = run(whole, stats, counts, nsteps=n, eps=eps)
    assert last.shape == () and last.device == device and not last.requires_grad
    found = [(last[None], whole)]
    single = copy.deepcopy(gsm)
    run = bt.make_gsm_train_scan(torch.optim.Adam(single.parameters(), lr=5e-2, capturable=True))
    elbos = torch.stack([run(single, stats, counts, nsteps=1,
                             eps={k: v[i:i + 1] for k, v in eps.items()}) for i in range(n)])
    found.append((elbos, single))
    eager_bitwise = torch.equal(e1, e2) and all(torch.equal(p, q) for p, q in
                                                zip(m1.parameters(), m2.parameters()))
    if variant != "hierarchical":
        assert eager_bitwise
    for got, model in found:
        want = e1[-len(got):]
        if eager_bitwise:
            assert torch.equal(got, want)
            assert all(torch.equal(p, q) for p, q in zip(model.parameters(), m1.parameters()))
        else:
            assert float(((got - want).abs() / want.abs()).max()) <= 1e-5
            for p, q in zip(model.parameters(), m1.parameters()):
                assert _rel(p.detach(), q.detach()) <= 1e-4
    assert float(elbos[-5:].mean()) > float(elbos[:5].mean())


def test_gsm_train_scan_on_the_card_draws_from_its_generator(device):
    """Without ``eps`` the graph draws from the registered generator: two
    runs from one seed agree, consecutive runs draw new noise (the
    generator advances), and an optimizer without ``capturable=True`` is
    refused before any capture."""
    gsm, (stats, _) = _gsm_problem(device, "plain")
    a, b = copy.deepcopy(gsm), copy.deepcopy(gsm)
    runs = [bt.make_gsm_train_scan(torch.optim.Adam(m.parameters(), lr=5e-2, capturable=True))
            for m in (a, b)]
    ga, gb = bt.train_key(1, device), bt.train_key(1, device)
    first = [run(m, stats, generator=g, nsteps=10)
             for run, m, g in ((runs[0], a, ga), (runs[1], b, gb))]
    assert torch.equal(first[0], first[1])
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    before = [p.detach().clone() for p in a.parameters()]
    runs[0](a, stats, generator=ga, nsteps=10)
    assert not all(torch.equal(p, q) for p, q in zip(a.parameters(), before))
    fresh = torch.randn(4, generator=bt.train_key(1, device), device=device)
    assert not torch.equal(torch.randn(4, generator=ga, device=device), fresh)
    with pytest.raises(ValueError, match="capturable=True"):
        bt.make_gsm_train_scan(torch.optim.Adam(gsm.parameters(), lr=5e-2))(gsm, stats, nsteps=2)


def test_the_one_host_sync_on_the_main_paths_is_named(device):
    """A VB step of a phone loop (50 × 3 states) and of an ergodic HMM of 30
    states with learned transitions, the benchmark's two training models,
    and a phone-loop decode, under ``torch.cuda.set_sync_debug_mode("warn")``:
    the host waits for the card once in the phone loop's step and once in
    its decode, at the band write of ``PhoneLoop._structured_trans`` (the
    span ``beer.sync.structured_trans``), and nowhere in the HMM's step."""
    gen = torch.Generator(device=device).manual_seed(7)
    x = torch.randn(16, 80, 39, device=device, generator=gen)
    lens = torch.randint(1, 81, (16, 1), device=device, generator=gen)
    m = (torch.arange(80, device=device)[None] < lens).float()

    def nset(size):
        return bt.NormalSet.create(torch.zeros(39, device=device), torch.ones(39, device=device),
                                   size=size, noise_std=0.5, generator=gen)

    loop = bt.PhoneLoop.create(50, 3, nset(150))
    hmm = bt.HMM.create(bt.ergodic(30), nset(30), learn_transitions=True)
    paths = {"loop": lambda: bt.vb_step(loop, x, mask=m)[0],
             "hmm": lambda: bt.vb_step(hmm, x, mask=m)[0],
             "decode": lambda: loop.decode_units(x, m)[1]}
    lines, first = inspect.getsourcelines(bt.PhoneLoop._structured_trans)
    site = ("phoneloop.py", first + next(i for i, line in enumerate(lines)
                                         if "a_adv[ends] = 0.0" in line))
    syncs = {}
    with torch.no_grad():
        for name, run in paths.items():
            run()          # builds the library and warms every shape
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = run()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            assert bool(torch.isfinite(out).all()), name
            syncs[name] = [(Path(w.filename).name, w.lineno) for w in got
                           if "synchronizing CUDA operation" in str(w.message)]
    assert syncs == {"loop": [site], "hmm": [], "decode": [site]}
