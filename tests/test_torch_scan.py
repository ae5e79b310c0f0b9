"""The plain versions of the port's scan kernels against beer_tpu.

Each kernel of ``beer_tpu_torch/ops/cuda_scan.py`` has a plain PyTorch
version, which is what its wrapper runs on CPU tensors: the four
phone-loop kernels K1–K4, their γ-emitting backward K11 and the three
dense-transition HMM kernels K5–K7.  Held against:

* the Pallas TPU kernel it replaces, run with ``interpret=True``, in
  float32.  Interpret mode computes in float32 even under the suite's
  x64, so the tolerance is rtol 1e-5: the summation orders over S and
  P differ, and the Pallas kernel gathers the ξ rows/columns with a
  two-pass bf16 selection product (measured gap ~4e-6 relative here);
  K11 is held against the banded mode of the γ-emitting Pallas kernel
  (``phone_loop_estep_ckpt_pass_lm`` with bands and in-kernel ELLH),
  which recomputes α̂ from block checkpoints;
* for K5–K7 also the batch-major twins the TPU routing picks when
  ``use_lane_major`` says no (``forward_llh_ckpt_pass``,
  ``phone_loop_estep_ckpt_pass``; ROADMAP B8), interpret mode, float32,
  same tolerance;
* the JAX general path (``forward_backward_probs``,
  ``expected_transition_counts_probs``, the XLA route of
  ``viterbi_banded``) in float64, to rtol 1e-9.

Shapes: U=4 units × 3 states, D=3 (P=6 reduced stats), B=4 with one
full, two ragged and one zero-length row, T=20; the dense kernels take
S=7 states with forbidden arcs, per-row init and per-row final vectors
whose last states are padding (final 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beer_tpu.ops import pallas_scan
from beer_tpu.ops import semiring_scan as jss
from beer_tpu_torch.ops import cuda_scan
from beer_tpu_torch.ops import semiring_scan as tss
from port_util import (B, D, SPU, T, U, close, dense_args, dense_problem,
                       port_args as _port_args, scan_problem, t)

S, P = U * SPU, 2 * D
RTOL_F32, RTOL_F64 = 1e-5, 1e-9


def _problem(seed: int = 7):
    return scan_problem(seed, U, SPU, P, B, T)


def _port_forward(a):
    return cuda_scan.forward_llh_banded_plain(a["stats"], a["lens"], a["w"], a["bias"],
                                              a["bands"], a["init"])


def _port_estep(a, alpha, norms):
    return cuda_scan.estep_acc_banded_plain(a["stats"], a["lens"], a["w"], a["bias"],
                                            a["bands"], a["final"], alpha, norms,
                                            a["ends"], a["starts"])


def _port_gamma(a, alpha, norms):
    return cuda_scan.estep_gamma_banded_plain(a["stats"], a["lens"], a["w"], a["bias"],
                                              a["bands"], a["final"], alpha, norms,
                                              a["ends"], a["starts"])


def _port_decode(a, llh):
    choices, exarg, alpha_last = cuda_scan.viterbi_fwd_banded_plain(
        llh, a["lens"], tss.log_bands(a["bands"]), tss.log_bands(a["init"]))
    paths, scores = cuda_scan.viterbi_backtrace_banded_plain(
        choices, exarg, alpha_last, tss.log_bands(a["final"]))
    return choices, exarg, alpha_last, paths, scores


# ----------------------------------------------------------------------
# float32: against the Pallas kernels in interpret mode
# ----------------------------------------------------------------------
def _pallas(pb):
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    bands = tuple(f32(v) for v in pb["bands"])
    stats_lm = jnp.transpose(f32(pb["stats"]), (1, 2, 0))
    mask = f32(pb["mask"])
    b = mask.shape[0]
    init_lm = jnp.broadcast_to(f32(pb["init"])[:, None], (S, b))
    final_lm = jnp.broadcast_to(f32(pb["final"])[:, None], (S, b))
    alphas, norms, last, logz = pallas_scan.forward_llh_ckpt_pass_lm(
        stats_lm, bands, init_lm, mask, interpret=True, w=f32(pb["w"]),
        bias=f32(pb["bias"]), store_alpha=True)
    sel_r = jax.nn.one_hot(pb["ends"], S, dtype=jnp.float32)
    sel_c = jax.nn.one_hot(pb["starts"], S, dtype=jnp.float32)
    acc2, counts, gamma0, xi = pallas_scan.phone_loop_estep_ckpt_acc_lm(
        None, None, bands, final_lm, mask, sel_r, sel_c, stats_lm, interpret=True,
        w=f32(pb["w"]), bias=f32(pb["bias"]), alphas=alphas, norms=norms)
    ckpts, _, _ = pallas_scan.forward_llh_ckpt_pass_lm(
        stats_lm, bands, init_lm, mask, interpret=True, w=f32(pb["w"]), bias=f32(pb["bias"]))
    gamma, xi_gamma = pallas_scan.phone_loop_estep_ckpt_pass_lm(
        stats_lm, ckpts, bands, final_lm, mask, sel_r, sel_c, interpret=True, w=f32(pb["w"]),
        bias=f32(pb["bias"]))
    return dict(alphas=np.asarray(alphas), norms=np.asarray(norms)[:, 0],
                last=np.asarray(last), logz=np.asarray(logz), acc2=np.asarray(acc2),
                counts=np.asarray(counts), gamma0=np.asarray(gamma0), xi=np.asarray(xi),
                gamma=np.asarray(gamma).transpose(2, 0, 1), xi_gamma=np.asarray(xi_gamma))


def _pallas_decode(pb, llh):
    lb = tss.log_bands(t(pb["bands"], torch.float32)).numpy()
    log_init = tss.log_bands(t(pb["init"], torch.float32)).numpy()
    log_final = tss.log_bands(t(pb["final"], torch.float32)).numpy()
    choices, exargs, alpha = pallas_scan.viterbi_fwd_banded(
        jnp.asarray(llh), tuple(jnp.asarray(v) for v in lb), jnp.asarray(log_init),
        jnp.asarray(pb["mask"], jnp.float32), interpret=True)
    best = jnp.argmax(alpha + log_final, axis=-1)
    paths = pallas_scan.viterbi_backtrace_banded(
        choices, exargs, jax.nn.one_hot(best, S, dtype=jnp.float32), interpret=True)
    return (np.asarray(choices).astype(np.int8), np.asarray(exargs), np.asarray(alpha),
            np.asarray(paths))


KERNEL_NAMES = ["forward_llh_banded", "estep_acc_banded", "viterbi_fwd_banded",
                "viterbi_backtrace_banded", "estep_gamma_banded"]
SCAN_KERNELS = ("forward_llh_banded", "estep_acc_banded", "estep_gamma_banded")
DENSE_KERNELS = ["forward_llh_dense", "estep_acc_dense", "estep_gamma_dense"]
S_DENSE = 7
# lengths across the chunked kernels' 16-frame chunk edge (K1 and K3 from
# frame 0, K7 and K11 from each utterance's end), and an empty row; K11 and
# K3 also take a one-frame row
CHUNK_EDGE_LENGTHS = [15, 16, 17, 33, 0]
CHUNK_EDGE_LENGTHS_ONE = [15, 16, 17, 33, 1, 0]
CHUNK_EDGE_CASES = ["forward_llh_banded_chunk_edges", "estep_gamma_banded_chunk_edges",
                    "viterbi_fwd_banded_chunk_edges"]


@pytest.mark.parametrize("kernel", KERNEL_NAMES + CHUNK_EDGE_CASES)
def test_plain_version_matches_pallas_f32(kernel):
    """The plain versions against the Pallas kernels in interpret mode;
    the ``_chunk_edges`` cases hold K1's, K11's and K3's plain versions
    (which the card holds the chunked kernels to) at lengths across a chunk
    edge."""
    edges = kernel in CHUNK_EDGE_CASES
    lengths = None
    if edges:
        lengths = CHUNK_EDGE_LENGTHS if kernel == "forward_llh_banded_chunk_edges" else CHUNK_EDGE_LENGTHS_ONE
    pb = scan_problem(7, U, SPU, P, len(lengths), max(lengths), lengths=lengths) if edges else _problem()
    kernel = kernel.removesuffix("_chunk_edges")
    a = _port_args(pb, torch.float32)
    lens = pb["lengths"]
    full = lens > 0
    if kernel in SCAN_KERNELS:
        ref = _pallas(pb)
        alpha, norms, last, logz = _port_forward(a)
        if kernel == "forward_llh_banded":
            for b in range(len(lens)):
                ln = lens[b]
                close(alpha[b, :ln], ref["alphas"][:ln, :, b], RTOL_F32, atol=1e-7)
                close(norms[b, :ln], ref["norms"][:ln, b], RTOL_F32)
                assert not alpha[b, ln:].any() and (norms[b, ln:] == 1).all()
            close(last, ref["last"].T, RTOL_F32, atol=1e-7)
            close(logz[full], ref["logz"][full], RTOL_F32)
            assert (logz[~full] == 0).all()
        elif kernel == "estep_gamma_banded":
            # the Pallas kernel's α̂ comes from block checkpoints: its γ
            # lies ~1e-6 from the float64 value, as in the dense case
            gamma, gamma0, xi = _port_gamma(a, alpha, norms)
            for b in range(len(lens)):
                close(gamma[b, :lens[b]], ref["gamma"][b, :lens[b]], RTOL_F32, atol=5e-6)
                assert not gamma[b, lens[b]:].any()
            close(gamma0[full], ref["gamma"][full, 0], RTOL_F32, atol=5e-6)
            assert not gamma0[~full].any()
            close(xi, ref["xi_gamma"], RTOL_F32, atol=1e-6)
        else:
            acc2, counts, gamma0, xi = _port_estep(a, alpha, norms)
            close(acc2, ref["acc2"], RTOL_F32, atol=1e-5)
            close(counts, ref["counts"], RTOL_F32)
            close(gamma0, ref["gamma0"].T, RTOL_F32, atol=1e-7)
            close(xi, ref["xi"], RTOL_F32, atol=1e-6)
    else:
        llh = (a["stats"] @ a["w"].T + a["bias"]).contiguous()
        choices, exarg, alpha_last, paths, _ = _port_decode(a, llh)
        ch_ref, ex_ref, al_ref, paths_ref = _pallas_decode(pb, llh.numpy())
        if kernel == "viterbi_fwd_banded":
            np.testing.assert_array_equal(choices.numpy(), ch_ref.transpose(1, 0, 2))
            np.testing.assert_array_equal(exarg.numpy(), ex_ref.T)
            close(alpha_last, al_ref, RTOL_F32)
        else:
            np.testing.assert_array_equal(paths.numpy(), paths_ref)


# ----------------------------------------------------------------------
# float64: against the JAX general path
# ----------------------------------------------------------------------
def _general(pb):
    llh = pb["stats"] @ pb["w"].T + pb["bias"]
    dense = np.asarray(jss.bands_to_dense(tuple(jnp.asarray(v) for v in pb["bands"])))
    logv = lambda v: np.where(v > 0, np.log(np.maximum(v, 1e-300)), -1e30)  # noqa: E731
    log_trans, log_init, log_final = logv(dense), logv(pb["init"]), logv(pb["final"])
    mask = jnp.asarray(pb["mask"])
    fbp = jss.forward_backward_probs(jnp.asarray(llh), jnp.asarray(log_trans),
                                     jnp.asarray(log_init), jnp.asarray(log_final), mask)
    xi = jss.expected_transition_counts_probs(fbp, jnp.asarray(log_trans), mask,
                                              rows=jnp.asarray(pb["ends"]),
                                              cols=jnp.asarray(pb["starts"]))
    post = np.asarray(fbp.posteriors)
    logcs = np.asarray(fbp.fwd_log_scales)
    norms = np.exp(np.diff(logcs, axis=1, prepend=0.0))
    return dict(llh=llh, log_trans=log_trans, log_init=log_init, log_final=log_final,
                log_z=np.asarray(fbp.log_z), alpha=np.asarray(fbp.probs_fwd), norms=norms,
                acc2=np.einsum("bts,btp->sp", post, pb["stats"]), counts=post.sum((0, 1)),
                gamma0=post[:, 0], gamma=post, xi=np.asarray(xi))


@pytest.mark.parametrize("kernel", KERNEL_NAMES)
def test_plain_version_matches_general_path_f64(kernel):
    pb = _problem(seed=11)
    a = _port_args(pb, torch.float64)
    ref = _general(pb)
    lens = pb["lengths"]
    full = lens > 0
    if kernel in SCAN_KERNELS:
        alpha, norms, last, logz_base = _port_forward(a)
        log_z = logz_base + torch.log((last * a["final"]).sum(-1))
        if kernel == "forward_llh_banded":
            close(log_z[full], ref["log_z"][full], RTOL_F64)
            for b in np.flatnonzero(full):
                ln = lens[b]
                close(alpha[b, :ln], ref["alpha"][b, :ln], RTOL_F64, atol=1e-300)
                close(norms[b, :ln], ref["norms"][b, :ln], RTOL_F64)
        elif kernel == "estep_gamma_banded":
            gamma, gamma0, xi_raw = _port_gamma(a, alpha, norms)
            dense = torch.exp(t(ref["log_trans"]))
            close(gamma, ref["gamma"], RTOL_F64, atol=1e-14)
            close(gamma0, ref["gamma0"], RTOL_F64, atol=1e-14)
            close(xi_raw * dense[a["ends"].long()][:, a["starts"].long()], ref["xi"], RTOL_F64,
                  atol=1e-14)
        else:
            acc2, counts, gamma0, xi_raw = _port_estep(a, alpha, norms)
            dense = torch.exp(t(ref["log_trans"]))
            xi = xi_raw * dense[a["ends"].long()][:, a["starts"].long()]
            close(acc2, ref["acc2"], RTOL_F64, atol=1e-12)
            close(counts, ref["counts"], RTOL_F64)
            close(gamma0, ref["gamma0"], RTOL_F64, atol=1e-14)
            close(xi, ref["xi"], RTOL_F64, atol=1e-14)
    else:
        llh = t(ref["llh"])
        _, _, _, paths, scores = _port_decode(a, llh)
        paths_ref, scores_ref = jss.viterbi_banded(
            jnp.asarray(ref["llh"]), tuple(jnp.asarray(v) for v in pb["bands"]),
            jnp.asarray(ref["log_init"]), jnp.asarray(ref["log_final"]),
            jnp.asarray(pb["mask"]))
        if kernel == "viterbi_fwd_banded":
            close(scores[full], np.asarray(scores_ref)[full], RTOL_F64)
        else:
            for b in np.flatnonzero(full):
                np.testing.assert_array_equal(paths[b, :lens[b]].numpy(),
                                              np.asarray(paths_ref)[b, :lens[b]])


@pytest.mark.parametrize("kernel", KERNEL_NAMES + DENSE_KERNELS)
def test_wrapper_runs_plain_version_on_cpu(kernel):
    """On CPU tensors each wrapper is its plain version, and no launch is counted."""
    pb = _problem(seed=3)
    a = _port_args(pb, torch.float32)
    cuda_scan.reset_launch_counts()
    alpha, norms, last, logz = _port_forward(a)
    llh = (a["stats"] @ a["w"].T + a["bias"]).contiguous()
    lb, li, lf = (tss.log_bands(a[k]) for k in ("bands", "init", "final"))
    choices, exarg, alpha_last = cuda_scan.viterbi_fwd_banded_plain(llh, a["lens"], lb, li)
    d = dense_args(dense_problem(3, S_DENSE, P, B, T), torch.float32)
    d_alpha, d_norms, _, _ = cuda_scan.forward_llh_dense_plain(d["llh"], d["lens"], d["trans"],
                                                               d["init"])
    cases = {
        "forward_llh_banded": (cuda_scan.forward_llh_banded, cuda_scan.forward_llh_banded_plain,
                               (a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["init"])),
        "estep_acc_banded": (cuda_scan.estep_acc_banded, cuda_scan.estep_acc_banded_plain,
                             (a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["final"],
                              alpha, norms, a["ends"], a["starts"])),
        "estep_gamma_banded": (cuda_scan.estep_gamma_banded, cuda_scan.estep_gamma_banded_plain,
                               (a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["final"],
                                alpha, norms, a["ends"], a["starts"])),
        "viterbi_fwd_banded": (cuda_scan.viterbi_fwd_banded, cuda_scan.viterbi_fwd_banded_plain,
                               (llh, a["lens"], lb, li)),
        "viterbi_backtrace_banded": (cuda_scan.viterbi_backtrace_banded,
                                     cuda_scan.viterbi_backtrace_banded_plain,
                                     (choices, exarg, alpha_last, lf)),
        "forward_llh_dense": (cuda_scan.forward_llh_dense, cuda_scan.forward_llh_dense_plain,
                              (d["stats"], d["lens"], d["trans"], d["init"], d["w"], d["bias"])),
        "estep_acc_dense": (cuda_scan.estep_acc_dense, cuda_scan.estep_acc_dense_plain,
                            (d["stats"], d["lens"], d["w"], d["bias"], d["trans"], d["final"],
                             d_alpha, d_norms)),
        "estep_gamma_dense": (cuda_scan.estep_gamma_dense, cuda_scan.estep_gamma_dense_plain,
                              (d["llh"], d["lens"], d["trans"], d["final"], d_alpha, d_norms)),
    }
    wrapper, plain, args = cases[kernel]
    for got, want in zip(wrapper(*args), plain(*args)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert all(k.launches == 0 for k in cuda_scan.KERNELS.values())


def test_bands_to_dense_matches_jax():
    pb = _problem()
    bands = pb["bands"]
    close(tss.bands_to_dense(t(bands)),
          jss.bands_to_dense(tuple(jnp.asarray(v) for v in bands)), 0.0)


def test_general_path_matches_jax_f64():
    """The port's general smoothing path (PhoneLoop.smooth's body) equals
    the JAX package's, posteriors and restricted ξ included."""
    pb = _problem(seed=5)
    ref = _general(pb)
    mask = t(pb["mask"])
    fbp = tss.forward_backward_probs(t(ref["llh"]), t(ref["log_trans"]), t(ref["log_init"]),
                                     t(ref["log_final"]), mask)
    full = pb["lengths"] > 0
    close(fbp.log_z[full], ref["log_z"][full], RTOL_F64)
    post = fbp.posteriors.numpy()
    close(post.sum((0, 1)), ref["counts"], RTOL_F64)
    close(post[:, 0], ref["gamma0"], RTOL_F64, atol=1e-14)
    xi = tss.expected_transition_counts_probs(fbp, t(ref["log_trans"]), mask,
                                              rows=t(pb["ends"]), cols=t(pb["starts"]))
    close(xi, ref["xi"], RTOL_F64, atol=1e-14)


# ----------------------------------------------------------------------
# K5–K7 (dense transitions, per-row init/final)
# ----------------------------------------------------------------------
def _dense_port(a):
    """Plain K5 in both input modes, K6 and K7 on one problem."""
    fwd_stats = cuda_scan.forward_llh_dense_plain(a["stats"], a["lens"], a["trans"], a["init"],
                                                  a["w"], a["bias"])
    fwd_llh = cuda_scan.forward_llh_dense_plain(a["llh"], a["lens"], a["trans"], a["init"])
    alpha, norms = fwd_stats[0], fwd_stats[1]
    acc = cuda_scan.estep_acc_dense_plain(a["stats"], a["lens"], a["w"], a["bias"], a["trans"],
                                          a["final"], alpha, norms)
    gam = cuda_scan.estep_gamma_dense_plain(a["llh"], a["lens"], a["trans"], a["final"],
                                            fwd_llh[0], fwd_llh[1])
    return fwd_stats, fwd_llh, acc, gam


def _dense_pallas_lane_major(pb):
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    stats_lm = jnp.transpose(f32(pb["stats"]), (1, 2, 0))
    llh_lm = jnp.einsum("sp,tpb->tsb", f32(pb["w"]), stats_lm) + f32(pb["bias"])[None, :, None]
    mask, trans = f32(pb["mask"]), f32(pb["trans"])
    init_lm, final_lm = f32(pb["init"]).T, f32(pb["final"]).T
    alphas, norms, last, logz = pallas_scan.forward_llh_ckpt_pass_lm(
        stats_lm, None, init_lm, mask, interpret=True, trans=trans, w=f32(pb["w"]),
        bias=f32(pb["bias"]), store_alpha=True)
    ckpts, last_llh, logz_llh = pallas_scan.forward_llh_ckpt_pass_lm(
        llh_lm, None, init_lm, mask, interpret=True, trans=trans)
    acc2, counts, gamma0, xi_acc = pallas_scan.phone_loop_estep_ckpt_acc_lm(
        None, None, None, final_lm, mask, None, None, stats_lm, interpret=True, trans=trans,
        w=f32(pb["w"]), bias=f32(pb["bias"]), alphas=alphas, norms=norms)
    gamma, xi_gamma = pallas_scan.phone_loop_estep_ckpt_pass_lm(
        llh_lm, ckpts, None, final_lm, mask, None, None, interpret=True, trans=trans)
    n = lambda x: np.asarray(x)  # noqa: E731
    return dict(alpha=n(alphas).transpose(2, 0, 1), norms=n(norms)[:, 0].T, last=n(last).T,
                logz=n(logz), last_llh=n(last_llh).T, logz_llh=n(logz_llh), acc2=n(acc2),
                counts=n(counts), gamma0=n(gamma0).T, xi_acc=n(xi_acc),
                gamma=n(gamma).transpose(2, 0, 1), xi_gamma=n(xi_gamma))


def _dense_pallas_batch_major(pb):
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    stats_tm = jnp.swapaxes(f32(pb["stats"]), 0, 1)
    w_ps, bias = f32(pb["w"]).T, f32(pb["bias"])
    llh_tm = stats_tm @ w_ps + bias
    mask, trans, init, final = (f32(pb[k]) for k in ("mask", "trans", "init", "final"))
    ckpts, last, logz = pallas_scan.forward_llh_ckpt_pass(stats_tm, trans, init, mask,
                                                          interpret=True, w=w_ps, bias=bias)
    ckpts_llh, last_llh, logz_llh = pallas_scan.forward_llh_ckpt_pass(llh_tm, trans, init, mask,
                                                                      interpret=True)
    xi_acc, acc2, counts, gamma0 = pallas_scan.phone_loop_estep_ckpt_pass(
        stats_tm, ckpts, trans, final, mask, None, None, interpret=True, w=w_ps, bias=bias,
        stats_tm=stats_tm)
    gamma, xi_gamma = pallas_scan.phone_loop_estep_ckpt_pass(
        llh_tm, ckpts_llh, trans, final, mask, None, None, interpret=True)
    n = lambda x: np.asarray(x)  # noqa: E731
    return dict(last=n(last), logz=n(logz), last_llh=n(last_llh), logz_llh=n(logz_llh),
                acc2=n(acc2), counts=n(counts), gamma0=n(gamma0), xi_acc=n(xi_acc),
                gamma=n(gamma).transpose(1, 0, 2), xi_gamma=n(xi_gamma))


def _check_dense(kernel, port, ref, lens, rtol):
    """One kernel's outputs against a reference's (rows with frames only
    for the per-row forward outputs)."""
    (alpha, norms, last, logz), (_, _, last_llh, logz_llh), acc, (gamma, xi_gamma) = port
    full = lens > 0
    if kernel == "forward_llh_dense":
        if "alpha" in ref:
            for b in np.flatnonzero(full):
                ln = lens[b]
                close(alpha[b, :ln], ref["alpha"][b, :ln], rtol, atol=1e-7)
                close(norms[b, :ln], ref["norms"][b, :ln], rtol)
        for got, want in ((last, ref["last"]), (last_llh, ref["last_llh"])):
            close(got[full], want[full], rtol, atol=1e-7)
        for got, want in ((logz, ref["logz"]), (logz_llh, ref["logz_llh"])):
            close(got[full], want[full], rtol)
    elif kernel == "estep_acc_dense":
        close(acc[0], ref["acc2"], rtol, atol=1e-5)
        close(acc[1], ref["counts"], rtol)
        close(acc[2][full], ref["gamma0"][full], rtol, atol=1e-7)
        close(acc[3], ref["xi_acc"], rtol, atol=1e-6)
    else:
        # the γ-emitting Pallas kernel recomputes α̂ from checkpoints with
        # its bf16×3 propagate: its γ lies 1e-6–2e-6 from the float64
        # value, the plain version's 1e-7–2e-7 (measured at this shape)
        for b in np.flatnonzero(full):
            close(gamma[b, :lens[b]], ref["gamma"][b, :lens[b]], rtol, atol=5e-6)
        close(xi_gamma, ref["xi_gamma"], rtol, atol=1e-6)


@pytest.mark.parametrize("kernel", DENSE_KERNELS + ["estep_gamma_dense_chunk_edges"])
def test_dense_plain_version_matches_pallas_f32(kernel):
    """``estep_gamma_dense_chunk_edges``: K7's plain version (which the card
    holds the chunked kernel to) at lengths across a chunk edge."""
    if kernel.endswith("_chunk_edges"):
        lengths = np.array(CHUNK_EDGE_LENGTHS)
        pb = dense_problem(13, S_DENSE, P, len(lengths), max(lengths), lengths=lengths)
        port = _dense_port(dense_args(pb, torch.float32))
        _check_dense("estep_gamma_dense", port, _dense_pallas_lane_major(pb), pb["lengths"], RTOL_F32)
        gamma = port[3][0]
        for b, ln in enumerate(lengths):
            assert not gamma[b, ln:].any()
        return
    pb = dense_problem(13, S_DENSE, P, B, T)
    port = _dense_port(dense_args(pb, torch.float32))
    _check_dense(kernel, port, _dense_pallas_lane_major(pb), pb["lengths"], RTOL_F32)
    gamma = port[3][0]
    assert not gamma[3].any() and not gamma[1, T - 7:].any()  # frames past each end


@pytest.mark.parametrize("kernel", DENSE_KERNELS)
def test_dense_plain_version_matches_batch_major_pallas_f32(kernel):
    """The batch-major twins (B8) compute what K5–K7 compute."""
    pb = dense_problem(17, S_DENSE, P, B, T)
    port = _dense_port(dense_args(pb, torch.float32))
    _check_dense(kernel, port, _dense_pallas_batch_major(pb), pb["lengths"], RTOL_F32)


def _dense_general(pb):
    llh = pb["stats"] @ pb["w"].T + pb["bias"]
    logv = lambda v: np.where(v > 0, np.log(np.maximum(v, 1e-300)), -1e30)  # noqa: E731
    log_trans = jnp.asarray(logv(pb["trans"]))
    mask = jnp.asarray(pb["mask"])
    fbp = jss.forward_backward_probs(jnp.asarray(llh), log_trans, jnp.asarray(logv(pb["init"])),
                                     jnp.asarray(logv(pb["final"])), mask)
    xi = np.asarray(jss.expected_transition_counts_probs(fbp, log_trans, mask))
    post = np.asarray(fbp.posteriors)
    logcs = np.asarray(fbp.fwd_log_scales)
    return dict(alpha=np.asarray(fbp.probs_fwd), norms=np.exp(np.diff(logcs, axis=1, prepend=0.0)),
                log_z=np.asarray(fbp.log_z), acc2=np.einsum("bts,btp->sp", post, pb["stats"]),
                counts=post.sum((0, 1)), gamma0=post[:, 0], gamma=post, xi=xi)


@pytest.mark.parametrize("kernel", DENSE_KERNELS)
def test_dense_plain_version_matches_general_path_f64(kernel):
    pb = dense_problem(19, S_DENSE, P, B, T)
    a = dense_args(pb, torch.float64)
    (alpha, norms, last, logz), fwd_llh, acc, (gamma, xi_g) = _dense_port(a)
    ref = _dense_general(pb)
    lens = pb["lengths"]
    full = lens > 0
    trans = a["trans"]
    if kernel == "forward_llh_dense":
        for out in ((alpha, norms, last, logz), fwd_llh):
            log_z = out[3] + torch.log((out[2] * a["final"]).sum(-1))
            close(log_z[full], ref["log_z"][full], RTOL_F64)
            for b in np.flatnonzero(full):
                close(out[0][b, :lens[b]], ref["alpha"][b, :lens[b]], RTOL_F64, atol=1e-300)
                close(out[1][b, :lens[b]], ref["norms"][b, :lens[b]], RTOL_F64)
    elif kernel == "estep_acc_dense":
        close(acc[0], ref["acc2"], RTOL_F64, atol=1e-12)
        close(acc[1], ref["counts"], RTOL_F64)
        close(acc[2], ref["gamma0"], RTOL_F64, atol=1e-14)
        close(acc[3] * trans, ref["xi"], RTOL_F64, atol=1e-14)
    else:
        close(gamma, ref["gamma"], RTOL_F64, atol=1e-14)
        close(xi_g * trans, ref["xi"], RTOL_F64, atol=1e-14)


def test_general_path_per_utterance_matches_jax_f64():
    """Per-utterance (B, S, S) matrices and (B, S) init/final through the
    port's general path and dense Viterbi equal the JAX package's."""
    rng = np.random.default_rng(23)
    s = 5
    pbs = [dense_problem(29 + b, s, P, B, T) for b in range(B)]
    trans = np.stack([pb["trans"] for pb in pbs])
    pb = pbs[0]
    llh = pb["stats"] @ pb["w"].T + pb["bias"] + rng.normal(size=(B, T, s))
    logv = lambda v: np.where(v > 0, np.log(np.maximum(v, 1e-300)), -1e30)  # noqa: E731
    args = (llh, logv(trans), logv(pb["init"]), logv(pb["final"]))
    mask = pb["mask"]
    fbp = tss.forward_backward_probs(*map(t, args), t(mask))
    jfbp = jss.forward_backward_probs(*map(jnp.asarray, args), jnp.asarray(mask))
    full = pb["lengths"] > 0
    close(fbp.log_z[full], np.asarray(jfbp.log_z)[full], RTOL_F64)
    close(fbp.posteriors, jfbp.posteriors, RTOL_F64, atol=1e-14)
    paths, scores = tss.viterbi(*map(t, args), t(mask))
    jpaths, jscores = jss.viterbi(*map(jnp.asarray, args), jnp.asarray(mask))
    for b in np.flatnonzero(full):
        np.testing.assert_array_equal(paths[b, :pb["lengths"][b]].numpy(),
                                      np.asarray(jpaths)[b, :pb["lengths"][b]])
        close(scores[b], jscores[b], RTOL_F64)


def test_library_path_is_keyed_on_sources(tmp_path, monkeypatch):
    """An edited kernel source gets a new library name (never served stale);
    nothing is compiled to compute it."""
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(cuda_scan, "CSRC", tmp_path)
    first = cuda_scan.library_path()
    src.write_text("// two\n")
    second = cuda_scan.library_path()
    assert first != second and first.parent == cuda_scan.BUILD_DIR
    assert not second.exists()


# ----------------------------------------------------------------------
# Where the dense kernels keep their (S, S) operands
# ----------------------------------------------------------------------
# (kernel, S, P, n_r, n_c, placement): the S of the large-HMM card tests
# (180, 300) and both sides of each kernel's shared-memory limit
# (the forward's two-stage ring of chunks moved its limit by one S, from
# 239 to 238 on the llh stream and from 203 to 202 at P = 78; its chunks
# shorten toward the limit, down to one frame; K7's chunked instances keep
# its limit at 168, K15's ring of gathered factors moved its limit at 50 ×
# 50 from 232 to 231)
PLACEMENTS = [
    ("forward_llh_dense", 180, 0, 0, 0, "shared"), ("forward_llh_dense", 239, 0, 0, 0, "global"),
    ("forward_llh_dense", 240, 0, 0, 0, "global"), ("forward_llh_dense", 300, 0, 0, 0, "global"),
    ("forward_llh_dense", 203, 78, 0, 0, "global"), ("forward_llh_dense", 204, 78, 0, 0, "global"),
    ("forward_llh_shifts_dense", 239, 0, 0, 0, "global"),
    ("forward_llh_shifts_dense", 240, 0, 0, 0, "global"),
    ("forward_llh_dense", 225, 0, 0, 0, "shared"), ("forward_llh_dense", 238, 0, 0, 0, "shared"),
    ("forward_llh_dense", 192, 78, 0, 0, "shared"), ("forward_llh_dense", 202, 78, 0, 0, "shared"),
    ("forward_llh_shifts_dense", 225, 0, 0, 0, "shared"),
    ("forward_llh_shifts_dense", 238, 0, 0, 0, "shared"),
    ("estep_acc_dense", 30, 78, 0, 0, "shared"), ("estep_acc_dense", 133, 78, 0, 0, "shared"),
    ("estep_acc_dense", 134, 78, 0, 0, "global"), ("estep_acc_dense", 180, 12, 0, 0, "global"),
    ("estep_acc_dense", 300, 78, 0, 0, "global"),
    ("estep_gamma_dense", 150, 0, 0, 0, "shared"), ("estep_gamma_dense", 168, 0, 0, 0, "shared"),
    ("estep_gamma_dense", 169, 0, 0, 0, "global"), ("estep_gamma_dense", 180, 0, 0, 0, "global"),
    ("estep_gamma_dense", 300, 0, 0, 0, "global"),
    ("estep_gamma_dense_restricted", 150, 0, 50, 50, "shared"),
    ("estep_gamma_dense_restricted", 232, 0, 50, 50, "global"),
    ("estep_gamma_dense_restricted", 233, 0, 50, 50, "global"),
    ("scaled_pass", 239, 0, 0, 0, "global"), ("scaled_pass", 240, 0, 0, 0, "global"),
    ("scaled_pass", 300, 0, 0, 0, "global"),
    ("smoothing_pass", 237, 0, 0, 0, "global"), ("smoothing_pass", 238, 0, 0, 0, "global"),
    ("smoothing_pass", 300, 0, 0, 0, "global"),
    # the grouped instances' limits: one utterance's M and carries fit a block to S = 237 (K12), 236 (K13)
    ("scaled_pass", 237, 0, 0, 0, "shared"), ("scaled_pass", 238, 0, 0, 0, "global"),
    ("smoothing_pass", 236, 0, 0, 0, "shared"),
]


@pytest.mark.parametrize("case", PLACEMENTS, ids=lambda c: "%s_S%d_P%d" % c[:3])
def test_dense_placement(case):
    """Shared memory while the operands fit a block (232,448 B), device
    memory above; the global placement itself fits at any S taken here."""
    kernel, s, p_dim, n_r, n_c, want = case
    assert cuda_scan.dense_placement(kernel, s, p_dim, n_r, n_c) == want
    shared = cuda_scan.dense_smem_bytes(kernel, s, p_dim, n_r, n_c, "shared")
    assert (shared <= cuda_scan.SMEM_LIMIT) == (want == "shared")
    glob = cuda_scan.dense_smem_bytes(kernel, s, p_dim, n_r, n_c, "global")
    # the forward, K6, K7 and K15 also stage their chunks: a two-stage ring
    # and e = exp(llh − max) (K6: and γ; the backward kernels a carry row
    # and per-frame sums; K15 its gathered ξ factors)
    ring = 0
    if kernel.startswith("forward"):
        chunk = cuda_scan.forward_chunk(s, p_dim, "global")
        ring = 4 * chunk * (2 * (p_dim or s) + s + 2)
    elif kernel == "estep_acc_dense":
        chunk = cuda_scan.backward_chunk(s, p_dim, "global")
        ring = 4 * (chunk * (2 * p_dim + 4 * s + 30) + 3 * s + 20)
    elif kernel.startswith("estep_gamma"):
        rc = (n_r, n_c) if kernel.endswith("restricted") else ()
        chunk = cuda_scan.gamma_chunk(s, "global", *rc)
        ring = 4 * (chunk * (5 * s + n_r + n_c + 30) + 3 * s + 20)
    if kernel in ("scaled_pass", "smoothing_pass"):
        # the grouped instances keep as many of M's rows in shared memory as fit beside the rest
        assert glob <= min(shared, cuda_scan.SMEM_LIMIT)
        return
    assert glob < shared and glob <= 4 * (7 * s + 64 + p_dim + n_r + n_c) + ring


# S -> {P: (instance, frames a chunk)} of K5/K14 (P = 0: the llh stream)
FORWARD_INSTANCES = {
    1: {0: ("warp", 32), 78: ("warp", 32), 184: ("warp", 32), 186: ("warp", 32),
        512: ("shared", 16)},
    30: {0: ("warp", 32), 78: ("warp", 32), 184: ("warp", 32), 186: ("shared", 16),
         512: ("shared", 16)},
    32: {0: ("warp", 32), 78: ("warp", 32), 184: ("warp", 32), 186: ("shared", 16),
         512: ("shared", 16)},
    33: {0: ("shared", 16), 78: ("shared", 16), 184: ("shared", 16), 186: ("shared", 16),
         512: ("shared", 16)},
    150: {0: ("shared", 16), 78: ("shared", 16), 184: ("shared", 8), 186: ("shared", 8),
          512: ("global", 16)},
    300: {0: ("global", 16), 78: ("global", 16), 184: ("global", 16), 186: ("global", 16),
          512: ("global", 16)},
}


@pytest.mark.parametrize("s", [1, 30, 32, 33, 150, 300])
def test_forward_instance(s):
    """K5/K14 take the one-warp instance for S <= 32 while its ring (four
    utterances' chunks of 32 frames) fits a block, and the block instance
    otherwise, in the shared placement while A (and W) fit: the instance
    is chosen by fit in one place, every choice fits, and
    ``dense_placement`` and ``dense_smem_bytes`` follow it."""
    for p_dim, want in FORWARD_INSTANCES[s].items():
        instance, chunk = cuda_scan.forward_instance(s, p_dim)
        assert (instance, chunk) == want
        assert cuda_scan.forward_smem_bytes(s, p_dim, instance, chunk) <= cuda_scan.SMEM_LIMIT
        warp_fits = cuda_scan.forward_smem_bytes(s, p_dim, "warp") <= cuda_scan.SMEM_LIMIT
        assert (instance == "warp") == (s <= 32 and warp_fits)
        placement = cuda_scan.dense_placement("forward_llh_dense", s, p_dim)
        assert placement == ("global" if instance == "global" else "shared")
        if instance != "warp":
            assert chunk == cuda_scan.forward_chunk(s, p_dim, instance)
            assert cuda_scan.dense_smem_bytes("forward_llh_dense", s, p_dim, placement=placement) == \
                cuda_scan.forward_smem_bytes(s, p_dim, instance, chunk)
            longer = [c for c in cuda_scan.FORWARD_CHUNKS if c > chunk]
            assert all(cuda_scan.forward_smem_bytes(s, p_dim, instance, c) > cuda_scan.SMEM_LIMIT
                       for c in longer)


@pytest.mark.parametrize("case", [
    # (S, P) -> (instance, frames a chunk): chunks shorten toward each limit
    ((225, 0), ("shared", 8)), ((235, 0), ("shared", 4)), ((238, 0), ("shared", 1)),
    ((239, 0), ("global", 16)), ((200, 78), ("shared", 4)), ((2000, 0), ("global", 8)),
    ((30, 2000), ("global", 8)), ((14511, 0), ("global", 1)),
])
def test_forward_chunks_shorten_near_the_limits(case):
    """Short chunks keep K5/K14 in the shared placement up to one S short
    of the unchunked kernel's limit, and take the global placement to
    S = 14,511 on the llh stream (K7's global limit is 9,672)."""
    (s, p_dim), want = case
    assert cuda_scan.forward_instance(s, p_dim) == want


def test_dense_placement_names_only_dense_kernels():
    with pytest.raises(ValueError, match="not a dense kernel"):
        cuda_scan.dense_placement("estep_acc_banded", 30)


# K6: S -> {P: (instance, frames a chunk)}: the warp instance (K2's kernel in
# its dense mode) for S <= 32 while its block fits (to P = 560 at S = 32),
# then the block instance, shared while A, W, the moments and ξ fit beside a
# one-frame chunk (to S = 133 at P = 78, as before the chunks), global above
BACKWARD_INSTANCES = {
    1: {78: ("warp", 16), 172: ("warp", 16)},
    30: {12: ("warp", 16), 78: ("warp", 16)},
    32: {78: ("warp", 16), 172: ("warp", 16), 560: ("warp", 16), 561: ("shared", 8), 2000: ("global", 8)},
    33: {78: ("shared", 16)},
    133: {78: ("shared", 1)},
    134: {78: ("global", 16)},
    150: {12: ("shared", 8), 78: ("global", 16)},
    300: {78: ("global", 16)},
}


@pytest.mark.parametrize("s", sorted(BACKWARD_INSTANCES))
def test_backward_instance(s):
    """K6's instance and chunk are chosen by fit in one place; every choice
    fits, the chunk is the longest that does, and ``dense_placement`` and
    ``dense_smem_bytes`` follow it."""
    for p_dim, want in BACKWARD_INSTANCES[s].items():
        instance, chunk = cuda_scan.backward_instance(s, p_dim)
        assert (instance, chunk) == want
        assert cuda_scan.backward_smem_bytes(s, p_dim, instance, chunk) <= cuda_scan.SMEM_LIMIT
        warp_fits = cuda_scan.acc_banded_smem_bytes(s, p_dim, s, "shared", 1, 16) <= cuda_scan.SMEM_LIMIT
        assert (instance == "warp") == (s <= 32 and warp_fits)
        if instance == "warp":   # a batch of many waves: the most utterances a block that fit
            n_utt = cuda_scan.backward_utterances(s, p_dim, MANY_WAVES, N_SM)
            assert cuda_scan.backward_smem_bytes(s, p_dim, "warp", 16, n_utt) == \
                cuda_scan.acc_banded_smem_bytes(s, p_dim, s, "shared", n_utt, 16) <= cuda_scan.SMEM_LIMIT
            assert all(cuda_scan.backward_smem_bytes(s, p_dim, "warp", 16, n) > cuda_scan.SMEM_LIMIT
                       for n in cuda_scan.ACC_UTTERANCES if n > n_utt)
        placement = cuda_scan.dense_placement("estep_acc_dense", s, p_dim)
        assert placement == ("global" if instance == "global" else "shared")
        if instance != "warp":
            assert chunk == cuda_scan.backward_chunk(s, p_dim, instance)
            assert cuda_scan.dense_smem_bytes("estep_acc_dense", s, p_dim, placement=placement) == \
                cuda_scan.backward_smem_bytes(s, p_dim, instance, chunk)
            assert all(cuda_scan.backward_smem_bytes(s, p_dim, instance, c) > cuda_scan.SMEM_LIMIT
                       for c in cuda_scan.BACKWARD_CHUNKS if c > chunk)


N_SM = 132            # an H100 SXM's SMs: the card the geometry cases are sized for
MANY_WAVES = 10_000   # a batch whose blocks outnumber two an SM at any utterances a block


def _check_chunked_geometry(size, b, geometry):
    """What the launch rule of K1 and K2 promises, checked on its answer
    (``size(placement, utterances a block, chunk)``: the block's shared
    memory): the block fits; no longer chunk fits anywhere; no more
    utterances a block than the fewest whose blocks run in one wave at two
    blocks an SM; a block that leaves its SM room for a second one when its
    blocks outnumber the SMs and such a block fits, else one that fits the
    SM alone; within that room the most utterances a block, and W in
    shared memory when it fits there."""
    placement, n_utt, chunk = geometry
    limit = cuda_scan.SMEM_LIMIT
    assert size(placement, n_utt, chunk) <= limit
    assert all(size("global", 1, c) > limit for c in cuda_scan.ACC_CHUNKS if c > chunk)
    cap = next((n for n in sorted(cuda_scan.ACC_UTTERANCES) if -(-b // n) <= 2 * N_SM), 4)
    takes = [n for n in cuda_scan.ACC_UTTERANCES if n <= cap]
    assert n_utt in takes

    def two_an_sm(n):
        return limit if -(-b // n) <= N_SM else cuda_scan.SMEM_HALF_SM

    room = two_an_sm if any(size("global", n, chunk) <= two_an_sm(n) for n in takes) else (lambda n: limit)
    assert size(placement, n_utt, chunk) <= room(n_utt)
    assert all(size("global", n, chunk) > room(n) for n in takes if n > n_utt)
    assert (placement == "shared") == (size("shared", n_utt, chunk) <= room(n_utt))
    assert size("global", n_utt, chunk) < size("shared", n_utt, chunk)


# (units, P, B) -> K2's (placement, utterances a block, frames a chunk): config
# 4 (50 units, B = 514), config 5's loop (10 units, P = 32, B = 258), 100
# and 250 units at phase 18's B = 64; at a batch of many waves, where the
# batch size caps nothing, both sides of each change of the rule (a block
# that leaves its SM room for a second one while one fits), the parent's
# limit (95 units ran, 96 raised), 1000 units and a large P (shorter chunks)
ACC_GEOMETRIES = [
    ((50, 78, 514), ("global", 2, 16)), ((10, 32, 258), ("shared", 1, 16)),
    ((14, 78, MANY_WAVES), ("shared", 4, 16)), ((15, 78, MANY_WAVES), ("global", 4, 16)),
    ((25, 78, MANY_WAVES), ("shared", 2, 16)), ((61, 78, MANY_WAVES), ("global", 2, 16)),
    ((62, 78, MANY_WAVES), ("global", 1, 16)), ((95, 78, MANY_WAVES), ("global", 1, 16)),
    ((96, 78, MANY_WAVES), ("global", 1, 16)), ((100, 78, 64), ("global", 1, 16)),
    ((133, 78, MANY_WAVES), ("global", 2, 16)), ((139, 78, MANY_WAVES), ("global", 1, 16)),
    ((250, 78, 64), ("global", 1, 16)), ((1000, 78, MANY_WAVES), ("global", 1, 2)),
    ((10, 2000, MANY_WAVES), ("global", 1, 8)),
]


@pytest.mark.parametrize("case", ACC_GEOMETRIES, ids=lambda c: "U%d_P%d" % c[0][:2])
def test_acc_banded_geometry(case):
    """K2's geometry is chosen by fit and the batch size in one place
    (:func:`_check_chunked_geometry`).  Every choice fits, so every phone
    loop of these sizes runs through the kernel (the parent's K2 refused
    96 units)."""
    (units, p_dim, b), want = case
    s = 3 * units
    geometry = cuda_scan.acc_banded_geometry(s, p_dim, units, b, N_SM)
    assert geometry == want
    _check_chunked_geometry(lambda pl, n, c: cuda_scan.acc_banded_smem_bytes(s, p_dim, units, pl, n, c), b, geometry)
    assert cuda_scan.banded_placement("estep_acc_banded", s, p_dim, units, b, N_SM) == geometry[0]


# (kernel, S, P, U, B, placement): K1 at config 4 (B = 514), at S = 674 and
# 675 (the per-frame kernel's shared limit; the chunked kernel's block, W
# beside its ring of chunks, leaves shared memory above S = 544 at B = 64)
# and at a large P; K11 at config 5 (shared), at 140 and 141 units (the
# per-frame kernel's shared limit; the chunked kernel's block, W and ξ
# beside its ring of chunks, leaves shared memory above 113 units at B =
# 64) and at a large P
BANDED_PLACEMENTS = [
    ("forward_llh_banded", 150, 78, 50, 514, "shared"), ("forward_llh_banded", 674, 78, 224, 64, "global"),
    ("forward_llh_banded", 675, 78, 225, 64, "global"), ("forward_llh_banded", 30, 2000, 10, 64, "global"),
    ("estep_gamma_banded", 30, 32, 10, 258, "shared"), ("estep_gamma_banded", 420, 78, 140, 64, "global"),
    ("estep_gamma_banded", 423, 78, 141, 64, "global"), ("estep_gamma_banded", 30, 2000, 10, 64, "global"),
]


@pytest.mark.parametrize("case", BANDED_PLACEMENTS, ids=lambda c: "%s_S%d_P%d" % c[:3])
def test_banded_placement(case):
    """W (and K11's ξ) in shared memory while they fit a block beside its
    chunks, else Wᵀ from device memory and ξ in the partial row; the global
    placement fits.  The placement is that of the geometry the wrapper
    launches at the batch size (:func:`test_forward_banded_geometry`,
    :func:`test_gamma_banded_geometry`)."""
    kernel, s, p_dim, units, b, want = case
    assert cuda_scan.banded_placement(kernel, s, p_dim, units, b, N_SM) == want
    if kernel == "forward_llh_banded":
        placement, n_utt, chunk = cuda_scan.forward_banded_geometry(s, p_dim, b, N_SM)
        size = lambda pl: cuda_scan.forward_banded_smem_bytes(s, p_dim, pl, n_utt, chunk)  # noqa: E731
    else:
        placement, n_utt, chunk = cuda_scan.gamma_banded_geometry(s, p_dim, units, b, N_SM)
        size = lambda pl: cuda_scan.gamma_banded_smem_bytes(s, p_dim, units, pl, n_utt, chunk)  # noqa: E731
    assert placement == want and size(want) <= cuda_scan.SMEM_LIMIT
    assert size("global") < size("shared")


def test_banded_placement_names_only_banded_kernels():
    # K1, K2, K3 and K11 have a banded placement; the dense kernels have dense_placement
    for kernel in ("estep_acc_dense", "estep_gamma_dense", "scaled_pass"):
        with pytest.raises(ValueError, match="not a banded scan kernel"):
            cuda_scan.banded_placement(kernel, 30, 78, 10, 64, N_SM)


# (S, (n_r, n_c) or () for K7's ξ over all states) -> K7's / K15's (instance,
# frames a chunk): the warp instance at configs 3 (S = 18) and 2 (30) and at
# S = 32, a non-square K15 block at S = 30; the block instance above (S =
# 33, phase 18's S = 150 shared with 16-frame chunks, both sides of the
# shared limit at S = 168 / 169, 300 and 750 global), K15 at config 4's
# shape (50 × 50 at S = 150) and both sides of its limit at 50 × 50; K7 at
# S = 9,674, the largest the per-frame kernel took (its one-frame global
# block keeps one ring stage), and at its limit, S = 14,508
GAMMA_INSTANCES = [
    ((18, ()), ("warp", 16)), ((30, ()), ("warp", 16)), ((32, ()), ("warp", 16)),
    ((30, (10, 15)), ("warp", 16)), ((33, ()), ("shared", 16)), ((150, ()), ("shared", 16)),
    ((168, ()), ("shared", 1)), ((169, ()), ("global", 16)), ((300, ()), ("global", 16)),
    ((750, ()), ("global", 8)), ((150, (50, 50)), ("shared", 16)), ((231, (50, 50)), ("shared", 1)),
    ((232, (50, 50)), ("global", 16)), ((300, (100, 150)), ("global", 16)),
    ((9674, ()), ("global", 1)), ((14508, ()), ("global", 1)),
]


@pytest.mark.parametrize("case", GAMMA_INSTANCES, ids=lambda c: "S%d_%s" % (c[0][0], "x".join(map(str, c[0][1])) or "full"))
def test_gamma_instance(case):
    """K7's and K15's launch is chosen by fit in one place: the warp
    instance for S <= 32 while its block fits one utterance (at a batch of
    many waves, the most utterances a block that fit); above, the block
    instance, shared while A and ξ fit beside a one-frame chunk, with the
    longest chunk that fits; every choice fits, and ``dense_placement`` and
    ``dense_smem_bytes`` follow it."""
    (s, rc), want = case
    instance, chunk = cuda_scan.gamma_instance(s, *rc)
    assert (instance, chunk) == want
    size = lambda inst, c, n=1: cuda_scan.gamma_smem_bytes(s, inst, c, n, *rc)  # noqa: E731
    assert size(instance, chunk) <= cuda_scan.SMEM_LIMIT
    assert (instance == "warp") == (s <= 32 and size("warp", 16, 1) <= cuda_scan.SMEM_LIMIT)
    kernel = "estep_gamma_dense_restricted" if rc else "estep_gamma_dense"
    placement = cuda_scan.dense_placement(kernel, s, 0, *rc)
    assert placement == ("global" if instance == "global" else "shared")
    if instance == "warp":
        n_utt = cuda_scan.gamma_utterances(s, MANY_WAVES, N_SM, *rc)
        assert size("warp", 16, n_utt) <= cuda_scan.SMEM_LIMIT
        assert all(size("warp", 16, n) > cuda_scan.SMEM_LIMIT for n in cuda_scan.ACC_UTTERANCES if n > n_utt)
        return
    assert (instance == "shared") == (size("shared", 1) <= cuda_scan.SMEM_LIMIT)
    assert chunk == cuda_scan.gamma_chunk(s, instance, *rc)
    assert all(size(instance, c) > cuda_scan.SMEM_LIMIT for c in cuda_scan.BACKWARD_CHUNKS if c > chunk)
    assert cuda_scan.dense_smem_bytes(kernel, s, 0, *(rc or (0, 0)), placement=placement) == size(instance, chunk)
    assert size("global", chunk) < size("shared", chunk)


# (S, B) -> utterances a block of K7's and K6's (P = 78) warp instances: the
# fewest whose blocks fill the card's 132 SMs in one wave at one block an SM
# (config 3's 128 and 130 rows: one; config 2's 514: four), the most that
# fit at a batch of many waves
GAMMA_WAVES = [((18, 128), 1), ((18, 132), 1), ((18, 133), 2), ((30, 200), 2), ((30, 264), 2),
               ((30, 265), 4), ((30, 514), 4), ((30, 2000), 4), ((32, 133), 2)]


@pytest.mark.parametrize("case", GAMMA_WAVES, ids=lambda c: "S%d_B%s" % c[0])
def test_gamma_instance_fills_the_card(case):
    """Given the batch size, K7's and K6's warp instances take the fewest
    utterances a block that still run in one wave (their chains are
    latency-bound, so fewer a block spread them over more SMs); the
    instance itself does not depend on it."""
    (s, b), want = case
    assert cuda_scan.gamma_instance(s) == ("warp", 16)
    n_utt = cuda_scan.gamma_utterances(s, b, N_SM)
    assert n_utt == want
    if -(-b // 4) <= N_SM:
        assert -(-b // n_utt) <= N_SM and (n_utt == 1 or -(-b // (n_utt // 2)) > N_SM)
    assert cuda_scan.backward_instance(s, 78)[0] == "warp"
    assert cuda_scan.backward_utterances(s, 78, b, N_SM) == want


def test_gamma_instance_gathers_only_a_restricted_block():
    """K15's block instance stages its gathered ξ factors and indices, K7's
    reads α̂ and v in place: at n_r = n_c = S the restricted block is the
    larger by those buffers alone."""
    s, c = 300, 16
    full = cuda_scan.gamma_smem_bytes(s, "global", c)
    restricted = cuda_scan.gamma_smem_bytes(s, "global", c, 1, s, s)
    assert restricted - full == 4 * (c * 2 * 300 + 600)


# (S, P, B) -> K1's (placement, utterances a block, frames a chunk): config 4
# (50 units, P = 78, B = 514), config 5 (10 units, P = 32, B = 258), 100 and
# 250 units at phase 18's B = 64; at a batch of many waves, the per-frame
# kernel's shared limit (S = 674 / 675), both sides of each change of the
# rule at P = 78 (W leaves shared memory above 40 units, four utterances a
# block give way to two above 85), 750 units (K2's limit is ~1,750), a
# large P, a 2,760-unit loop (S = 8,280, which the per-frame kernel took in
# its global placement) and the new limit at P = 78 (S = 9,650)
FORWARD_GEOMETRIES = [
    ((150, 78, 514), ("shared", 2, 16)), ((30, 32, 258), ("shared", 1, 16)), ((300, 78, 64), ("shared", 1, 16)),
    ((750, 78, 64), ("global", 1, 16)), ((674, 78, MANY_WAVES), ("global", 1, 16)),
    ((675, 78, MANY_WAVES), ("global", 1, 16)), ((120, 78, MANY_WAVES), ("shared", 4, 16)),
    ((123, 78, MANY_WAVES), ("global", 4, 16)), ((255, 78, MANY_WAVES), ("global", 4, 16)),
    ((258, 78, MANY_WAVES), ("global", 2, 16)), ((2250, 78, MANY_WAVES), ("global", 1, 16)),
    ((30, 2000, MANY_WAVES), ("global", 1, 8)), ((8280, 78, MANY_WAVES), ("global", 1, 1)),
    ((9650, 78, MANY_WAVES), ("global", 1, 1)),
]


@pytest.mark.parametrize("case", FORWARD_GEOMETRIES, ids=lambda c: "S%d_P%d" % c[0][:2])
def test_forward_banded_geometry(case):
    """K1's geometry is chosen by fit and the batch size in one place, by
    K2's rule (:func:`_check_chunked_geometry`).  Every choice fits, so
    every phone loop the per-frame kernel took (to S = 8,281 at P = 78)
    runs."""
    (s, p_dim, b), want = case
    geometry = cuda_scan.forward_banded_geometry(s, p_dim, b, N_SM)
    assert geometry == want
    _check_chunked_geometry(lambda pl, n, c: cuda_scan.forward_banded_smem_bytes(s, p_dim, pl, n, c), b, geometry)
    assert cuda_scan.banded_placement("forward_llh_banded", s, p_dim, s // 3, b, N_SM) == geometry[0]


# (S, P, B) -> K1's geometry as the batch size changes (132 SMs): config 4's
# loop at B = 514 (two utterances a block, W shared beside a second block
# an SM), at a batch too large for one wave (W from device memory, four a
# block) and at a tiny one; config 5's (B = 258: one); 100 units at B = 64
# (one a block, as many blocks as SMs or fewer: W shared while it fits at
# all) and 200 (one, W from device memory); 250 units and a large P
FORWARD_WAVES = [
    ((150, 78, 514), ("shared", 2, 16)), ((30, 32, 258), ("shared", 1, 16)), ((300, 78, 64), ("shared", 1, 16)),
    ((750, 78, 64), ("global", 1, 16)), ((150, 78, 2000), ("global", 4, 16)), ((150, 78, 4), ("shared", 1, 16)),
    ((300, 78, 200), ("global", 1, 16)), ((30, 2000, 64), ("global", 1, 8)),
]


@pytest.mark.parametrize("case", FORWARD_WAVES, ids=lambda c: "S%d_P%d_B%d" % c[0])
def test_forward_banded_geometry_fills_the_card(case):
    """Given the batch size, K1 takes the longest chunk that fits, no more
    utterances a block than the fewest whose blocks run in one wave at two
    blocks an SM, and W in shared memory while that block still lets the
    wave run at once; every choice fits."""
    (s, p_dim, b), want = case
    placement, n_utt, chunk = cuda_scan.forward_banded_geometry(s, p_dim, b, N_SM)
    assert (placement, n_utt, chunk) == want
    size = lambda pl, n: cuda_scan.forward_banded_smem_bytes(s, p_dim, pl, n, chunk)  # noqa: E731
    assert size(placement, n_utt) <= cuda_scan.SMEM_LIMIT
    blocks = -(-b // n_utt)
    if -(-b // 4) <= 2 * N_SM:
        assert blocks <= 2 * N_SM and (n_utt == 1 or -(-b // (n_utt // 2)) > 2 * N_SM)
    tier = cuda_scan.SMEM_LIMIT if blocks <= N_SM else cuda_scan.SMEM_HALF_SM
    assert (placement == "shared") == (size("shared", n_utt) <= tier) or size("global", n_utt) > tier


def test_forward_banded_geometry_has_a_limit():
    """Above S = 9,655 at P = 78 no K1 block fits; the geometry then names
    the smallest one, which the launch refuses."""
    assert cuda_scan.forward_banded_geometry(9660, 78, 64, N_SM) == ("global", 1, 1)
    assert cuda_scan.forward_banded_smem_bytes(9660, 78, "global", 1, 1) > cuda_scan.SMEM_LIMIT
    assert cuda_scan.forward_banded_smem_bytes(9655, 78, "global", 1, 1) <= cuda_scan.SMEM_LIMIT


# (U, P, B) -> K11's (placement, utterances a block, frames a chunk): config
# 4's loop (B = 514) and config 5's (B = 258), 100 and 250 units at phase
# 18's B = 64; at a batch of many waves both sides of each change of the
# rule (W and ξ leave shared memory above 14 units at four utterances a
# block, above 30 at two; one a block above 61), the per-frame kernel's
# shared limit (140 / 141 units), 1,000 units, a large P, and the largest
# loop the per-frame kernel took (1,656 units at P = 78, one-frame chunks)
GAMMA_BANDED_GEOMETRIES = [
    ((50, 78, 514), ("global", 2, 16)), ((10, 32, 258), ("shared", 1, 16)), ((100, 78, 64), ("shared", 1, 16)),
    ((250, 78, 64), ("global", 1, 16)), ((14, 78, MANY_WAVES), ("shared", 4, 16)),
    ((15, 78, MANY_WAVES), ("shared", 4, 16)), ((20, 78, MANY_WAVES), ("global", 4, 16)),
    ((30, 78, MANY_WAVES), ("shared", 2, 16)), ((40, 78, MANY_WAVES), ("global", 2, 16)),
    ((61, 78, MANY_WAVES), ("global", 2, 16)), ((62, 78, MANY_WAVES), ("global", 1, 16)),
    ((140, 78, MANY_WAVES), ("global", 1, 16)), ((141, 78, MANY_WAVES), ("global", 1, 16)),
    ((1000, 78, MANY_WAVES), ("global", 1, 2)), ((10, 2000, MANY_WAVES), ("global", 1, 8)),
    ((1656, 78, MANY_WAVES), ("global", 1, 1)),
]


@pytest.mark.parametrize("case", GAMMA_BANDED_GEOMETRIES, ids=lambda c: "U%d_P%d_B%d" % c[0])
def test_gamma_banded_geometry(case):
    """K11's geometry is chosen by fit and the batch size in one place, by
    K2's rule (:func:`_check_chunked_geometry`); its block is K2's without
    the moments.  Every choice fits, so every phone loop of these sizes
    runs through the kernel."""
    (units, p_dim, b), want = case
    s = 3 * units
    geometry = cuda_scan.gamma_banded_geometry(s, p_dim, units, b, N_SM)
    assert geometry == want
    size = lambda pl, n, c: cuda_scan.gamma_banded_smem_bytes(s, p_dim, units, pl, n, c)  # noqa: E731
    _check_chunked_geometry(size, b, geometry)
    assert cuda_scan.banded_placement("estep_gamma_banded", s, p_dim, units, b, N_SM) == geometry[0]
    placement, n_utt, chunk = geometry
    moments = 4 * 3 * units * (-(-(p_dim + 1) // 4) * 4)
    assert size("shared", n_utt, chunk) == \
        cuda_scan.acc_banded_smem_bytes(s, p_dim, units, "shared", n_utt, chunk) - moments
    assert size("global", n_utt, chunk) == cuda_scan.acc_banded_smem_bytes(s, p_dim, units, "global", n_utt, chunk)


def test_gamma_banded_geometry_has_a_limit():
    """Every loop of three-state units the per-frame K11 took (11·S + P +
    2U + 64 floats, to 1,656 units at P = 78) runs; above 1,704 units no
    block fits, and the geometry names the smallest one, which the launch
    refuses."""
    per_frame = lambda u, p: 4 * (11 * 3 * u + p + 2 * u + 64)  # noqa: E731
    largest = max(u for u in range(1, 3000) if per_frame(u, 78) <= cuda_scan.SMEM_LIMIT)
    assert largest == 1656
    assert cuda_scan.gamma_banded_smem_bytes(3 * largest, 78, largest, "global", 1, 1) <= cuda_scan.SMEM_LIMIT
    assert cuda_scan.gamma_banded_smem_bytes(3 * 1704, 78, 1704, "global", 1, 1) <= cuda_scan.SMEM_LIMIT
    assert cuda_scan.gamma_banded_geometry(3 * 1705, 78, 1705, 64, N_SM) == ("global", 1, 1)
    assert cuda_scan.gamma_banded_smem_bytes(3 * 1705, 78, 1705, "global", 1, 1) > cuda_scan.SMEM_LIMIT


# (S, B) -> K3's (placement, utterances a block, frames a chunk): config 4's
# loop (B = 514), config 5's (B = 256), the recognizer's S = 18 (B = 128),
# phase 18's loops at B = 64; at a batch of many waves the changes of the
# rule (four utterances a block to S = 150, two to the warp chain's 192, one above,
# where a block walks one chain; the bands leave shared memory where only
# the global block leaves its SM room for a second one), shorter chunks
# toward the largest S, and the per-frame kernel's limit (9,674) and the
# new one (16,564)
VITERBI_GEOMETRIES = [
    ((150, 514), ("shared", 2, 16)), ((30, 256), ("shared", 1, 16)), ((18, 128), ("shared", 1, 16)),
    ((300, 64), ("shared", 1, 16)), ((750, 64), ("shared", 1, 16)), ((18, MANY_WAVES), ("shared", 4, 16)),
    ((150, MANY_WAVES), ("shared", 4, 16)), ((192, MANY_WAVES), ("shared", 2, 16)),
    ((193, MANY_WAVES), ("shared", 1, 16)), ((300, MANY_WAVES), ("shared", 1, 16)),
    ((450, MANY_WAVES), ("shared", 1, 16)), ((750, MANY_WAVES), ("shared", 1, 16)),
    ((2000, MANY_WAVES), ("shared", 1, 8)), ((5000, MANY_WAVES), ("global", 1, 4)),
    ((9674, 64), ("global", 1, 1)), ((16564, MANY_WAVES), ("global", 1, 1)),
]


@pytest.mark.parametrize("case", VITERBI_GEOMETRIES, ids=lambda c: "S%d_B%d" % c[0])
def test_viterbi_banded_geometry(case):
    """K3's geometry is chosen by fit and the batch size in one place, by
    K1's rule (:func:`_check_chunked_geometry`); every choice fits, and
    above the warp chain's S one utterance a block takes the whole block."""
    (s, b), want = case
    geometry = cuda_scan.viterbi_banded_geometry(s, b, N_SM)
    assert geometry == want
    assert s <= cuda_scan.VIT_WARP_STATES or geometry[1] == 1
    _check_chunked_geometry(lambda pl, n, c: cuda_scan.viterbi_launch_bytes(s, pl, n, c), b, geometry)
    assert cuda_scan.banded_placement("viterbi_fwd_banded", s, 0, 0, b, N_SM) == geometry[0]


def test_viterbi_banded_geometry_has_a_limit():
    """Every S the per-frame K3 took (6·S + 64 floats, to S = 9,674) runs;
    above S = 16,564 no block fits, and the geometry names the smallest
    one, which the launch refuses."""
    largest = max(s for s in range(1, 20000) if 4 * (6 * s + 64) <= cuda_scan.SMEM_LIMIT)
    assert largest == 9674
    placement, n_utt, chunk = cuda_scan.viterbi_banded_geometry(largest, 64, N_SM)
    assert cuda_scan.viterbi_banded_smem_bytes(largest, placement, n_utt, chunk) <= cuda_scan.SMEM_LIMIT
    assert cuda_scan.viterbi_banded_smem_bytes(16564, "global", 1, 1) <= cuda_scan.SMEM_LIMIT
    assert cuda_scan.viterbi_banded_geometry(16565, 64, N_SM) == ("global", 1, 1)
    assert cuda_scan.viterbi_banded_smem_bytes(16565, "global", 1, 1) > cuda_scan.SMEM_LIMIT


# (S, B) -> K4's (instance, utterances a block, frames a chunk): the
# decodes of config 3 (S = 18), config 5's loop (S = 30) and config 4's
# (S = 150) at B = 8 and 514 and at their own batches (128, 258), phase
# 18's loops (S = 300 and 750 staged; 2,100 and, on 8 rows, 9,600 direct),
# both sides of the staged instance's last S (1,024), K3's limit (16,564),
# and at a batch of many waves: four utterances a block, the chunk
# shortened so that a wave's blocks share an SM
BACKTRACE_GEOMETRIES = [
    ((18, 8), ("staged", 1, 16)), ((30, 8), ("staged", 1, 16)), ((150, 8), ("staged", 1, 16)),
    ((18, 514), ("staged", 1, 16)), ((30, 514), ("staged", 1, 16)), ((150, 514), ("staged", 1, 16)),
    ((18, 128), ("staged", 1, 16)), ((30, 258), ("staged", 1, 16)), ((300, 64), ("staged", 1, 16)),
    ((750, 64), ("staged", 1, 16)), ((1024, 64), ("staged", 1, 16)), ((1025, 64), ("direct", 1, 32)),
    ((2100, 64), ("direct", 1, 32)), ((9600, 8), ("direct", 1, 32)), ((16564, 64), ("direct", 1, 32)),
    ((18, MANY_WAVES), ("staged", 4, 16)), ((150, MANY_WAVES), ("staged", 4, 4)),
    ((1024, MANY_WAVES), ("staged", 4, 8)), ((2100, MANY_WAVES), ("direct", 4, 32)),
]


def _check_backtrace_geometry(s, b, geometry):
    """What K4's launch rule promises, checked on its answer: a block takes
    the fewest utterances whose blocks run in one wave at eight an SM;
    "direct" exactly above the staged instance's last S; a staged block
    fits, with the longest chunk whose block leaves room for the wave's
    other blocks on an SM, else (no chunk does) the longest that fits a
    block."""
    instance, n_utt, chunk = geometry
    limit = cuda_scan.SMEM_LIMIT
    size = cuda_scan.backtrace_smem_bytes
    cap = next((n for n in sorted(cuda_scan.ACC_UTTERANCES) if -(-b // n) <= 8 * N_SM), 4)
    assert n_utt == cap
    if instance == "direct":
        assert s > cuda_scan.BT_STAGED_STATES and chunk == cuda_scan.BT_DIRECT_CHUNK
        return
    assert instance == "staged" and s <= cuda_scan.BT_STAGED_STATES and chunk in cuda_scan.BT_CHUNKS
    assert size(s, n_utt, chunk) <= limit
    per_sm = -(-(-(-b // cap)) // N_SM)
    room = min(233472 // per_sm - 1024, limit)
    if size(s, n_utt, chunk) > room:
        assert all(size(s, n_utt, c) > room for c in cuda_scan.BT_CHUNKS)
        room = limit
    assert all(size(s, n_utt, c) > room for c in cuda_scan.BT_CHUNKS if c > chunk)


@pytest.mark.parametrize("case", BACKTRACE_GEOMETRIES, ids=lambda c: "S%d_B%d" % c[0])
def test_backtrace_banded_geometry(case):
    """K4's geometry is chosen by S and the batch size in one place: one
    warp an utterance, spread over the SMs (config 4's 514 utterances on
    514 blocks, where the per-thread kernel took 5 SMs), its choices staged
    in shared memory up to S = 1,024 (:func:`_check_backtrace_geometry`)."""
    (s, b), want = case
    geometry = cuda_scan.backtrace_banded_geometry(s, b, N_SM)
    assert geometry == want
    _check_backtrace_geometry(s, b, geometry)


def test_backtrace_banded_geometry_takes_every_s():
    """The per-thread K4 used no shared memory and refused no S: every S
    to K3's limit (16,564) and far above runs, the staged instance's
    blocks fit (at S = 1,024 one frame of four utterances takes 16,640
    bytes), and the direct chase uses no shared memory."""
    assert cuda_scan.backtrace_smem_bytes(cuda_scan.BT_STAGED_STATES, 4, 1) == 16640
    for s in [*range(1, 2000, 37), *range(2000, 70_000, 997), 16564, 200_000]:
        for b in (1, 8, 514, MANY_WAVES):
            geometry = cuda_scan.backtrace_banded_geometry(s, b, N_SM)
            assert geometry[0] == ("staged" if s <= cuda_scan.BT_STAGED_STATES else "direct")
            _check_backtrace_geometry(s, b, geometry)


# (S, B) -> K13 banded's (placement, utterances a block, frames a chunk):
# config 4's loop with phase 15's two empty rows (B = 514) and config 5's
# (B = 258) and at config 4's batch (S = 30), the recognizer's S = 18, both
# sides of the warp chain's last register (192, 193), phase 15's S = 450
# (the block chain), phase 18's loops at B = 64 (a block an SM: the longest
# chunk), many waves, the bands' last S in shared memory (4,822) and the
# largest S that runs (7,234)
SMOOTHING_GEOMETRIES = [
    ((150, 514), ("shared", 2, 8)), ((30, 258), ("shared", 1, 16)), ((30, 514), ("shared", 2, 16)),
    ((18, 128), ("shared", 1, 16)), ((150, 8), ("shared", 1, 16)), ((192, 514), ("shared", 2, 8)),
    ((193, 514), ("shared", 1, 16)), ((450, 514), ("shared", 1, 4)), ((300, 64), ("shared", 1, 16)),
    ((750, 64), ("shared", 1, 8)), ((30, MANY_WAVES), ("shared", 4, 16)), ((150, MANY_WAVES), ("shared", 4, 4)),
    ((450, MANY_WAVES), ("shared", 1, 4)), ((2000, MANY_WAVES), ("shared", 1, 1)), ((4822, 64), ("shared", 1, 1)),
    ((6449, 64), ("global", 1, 1)), ((7234, 8), ("global", 1, 1)),
]


def _check_smoothing_geometry(s, b, geometry, smem_bytes=cuda_scan.smoothing_banded_smem_bytes):
    """What K13 banded's launch rule (and K12 banded's, with its
    ``smem_bytes``) promises: the block fits; the most
    utterances a block that fit up to the fewest whose blocks run in one
    wave at two an SM (one above the warp chain's S); at those, a block
    that leaves its SM room for a second one where one such fits (its blocks
    outnumbering the SMs), then the longest chunk, the bands in shared
    memory when they fit there."""
    placement, n_utt, chunk = geometry
    limit, half = cuda_scan.SMEM_LIMIT, cuda_scan.SMEM_HALF_SM
    size = lambda pl, n, c: smem_bytes(s, pl, n, c)  # noqa: E731
    assert size(placement, n_utt, chunk) <= limit
    cap = next((n for n in sorted(cuda_scan.ACC_UTTERANCES) if -(-b // n) <= 2 * N_SM), 4)
    cap = cap if s <= cuda_scan.SMO_WARP_STATES else 1
    assert n_utt <= cap
    assert all(size("global", n, 1) > limit for n in cuda_scan.ACC_UTTERANCES if n_utt < n <= cap)
    room = limit if -(-b // n_utt) <= N_SM else half
    room = room if size("global", n_utt, 1) <= room else limit
    assert size(placement, n_utt, chunk) <= room
    assert all(size("global", n_utt, c) > room for c in cuda_scan.ACC_CHUNKS if c > chunk)
    assert placement == "shared" or size("shared", n_utt, chunk) > room


@pytest.mark.parametrize("case", SMOOTHING_GEOMETRIES, ids=lambda c: "S%d_B%d" % c[0])
def test_smoothing_banded_geometry(case):
    """K13 banded's geometry is chosen by fit and the batch size in one
    place (:func:`_check_smoothing_geometry`); every choice fits."""
    (s, b), want = case
    geometry = cuda_scan.smoothing_banded_geometry(s, b, N_SM)
    assert geometry == want
    _check_smoothing_geometry(s, b, geometry)


def test_smoothing_banded_geometry_has_a_limit():
    """Every S the per-frame K13 banded took (9·S + 64 floats, to S =
    6,449) runs; the bands leave shared memory above S = 4,822 and above S
    = 7,234 no block fits, and the geometry names the smallest one, which
    the launch refuses."""
    largest = max(s for s in range(1, 20000) if 4 * (9 * s + 64) <= cuda_scan.SMEM_LIMIT)
    assert largest == 6449
    for s in (*range(1, 7235, 53), largest, 7234):
        for b in (8, 514, MANY_WAVES):
            _check_smoothing_geometry(s, b, cuda_scan.smoothing_banded_geometry(s, b, N_SM))
    assert cuda_scan.smoothing_banded_geometry(4822, 64, N_SM)[0] == "shared"
    assert cuda_scan.smoothing_banded_geometry(4823, 64, N_SM)[0] == "global"
    assert cuda_scan.smoothing_banded_smem_bytes(7234, "global", 1, 1) <= cuda_scan.SMEM_LIMIT
    assert cuda_scan.smoothing_banded_geometry(7235, 64, N_SM) == ("global", 1, 1)
    assert cuda_scan.smoothing_banded_smem_bytes(7235, "global", 1, 1) > cuda_scan.SMEM_LIMIT


# (S, B) -> K12 banded's (placement, utterances a block, frames a chunk),
# at the shapes of SMOOTHING_GEOMETRIES: its blocks hold one ring (e) where
# K13's hold two (e and α̂) and u1, so its chunks are longer; above S =
# 5,795 a longer chunk with the bands in device memory beats a shorter one
# with them in shared memory, and the parent's largest S (9,674) and the
# largest that runs (19,318) fit
SCALED_BANDED_GEOMETRIES = [
    ((150, 514), ("shared", 2, 16)), ((30, 258), ("shared", 1, 16)), ((30, 514), ("shared", 2, 16)),
    ((18, 128), ("shared", 1, 16)), ((150, 8), ("shared", 1, 16)), ((192, 514), ("shared", 2, 16)),
    ((193, 514), ("shared", 1, 16)), ((450, 514), ("shared", 1, 16)), ((300, 64), ("shared", 1, 16)),
    ((750, 64), ("shared", 1, 16)), ((30, MANY_WAVES), ("shared", 4, 16)), ((150, MANY_WAVES), ("shared", 4, 8)),
    ((2000, MANY_WAVES), ("global", 1, 4)), ((5795, 8), ("shared", 1, 2)), ((5796, 8), ("global", 1, 2)),
    ((9674, 8), ("global", 1, 1)), ((19318, 8), ("global", 1, 1)),
]


@pytest.mark.parametrize("case", SCALED_BANDED_GEOMETRIES, ids=lambda c: "S%d_B%d" % c[0])
def test_scaled_banded_geometry(case):
    """K12 banded's geometry is chosen by fit and the batch size in one
    place, by K13 banded's rule (:func:`_check_smoothing_geometry`)."""
    (s, b), want = case
    geometry = cuda_scan.scaled_banded_geometry(s, b, N_SM)
    assert geometry == want
    _check_smoothing_geometry(s, b, geometry, cuda_scan.scaled_banded_smem_bytes)


def test_scaled_banded_geometry_takes_every_s_the_parent_took():
    """Every S the per-frame K12 banded took ((6S + 64) floats, to S =
    9,674) runs in chunks, and so does every S to 19,318; above, no block
    fits and the geometry names the smallest one, which the launch
    refuses."""
    parent = max(s for s in range(1, 20000) if 4 * (6 * s + 64) <= cuda_scan.SMEM_LIMIT)
    assert parent == 9674
    for s in (*range(1, 19319, 61), parent, 19318):
        for b in (8, 514, MANY_WAVES):
            geometry = cuda_scan.scaled_banded_geometry(s, b, N_SM)
            assert cuda_scan.scaled_banded_smem_bytes(s, *geometry) <= cuda_scan.SMEM_LIMIT
            _check_smoothing_geometry(s, b, geometry, cuda_scan.scaled_banded_smem_bytes)
    assert cuda_scan.scaled_banded_geometry(19319, 8, N_SM) == ("global", 1, 1)
    assert cuda_scan.scaled_banded_smem_bytes(19319, "global", 1, 1) > cuda_scan.SMEM_LIMIT


# (kernel, S, B) -> the dense instances' (placement, utterances a block,
# slices): config 4's matrix (S = 150) at phase 15's B = 514, config 5's
# loop (S = 30) at its B = 258, phase 18's B = 64 at S = 150 (shared) and
# 300 (global), phase 15's S = 450, both sides of the shared limit (K12 237,
# K13 236), S = 1, one slice from S = 513 on, many waves, and the parents'
# global limits (K12 29,024; K13 11,609)
GROUPED_GEOMETRIES = [
    (("scaled_pass", 150, 514), ("shared", 2, 6)), (("smoothing_pass", 150, 514), ("shared", 2, 6)),
    (("scaled_pass", 30, 258), ("shared", 1, 8)), (("smoothing_pass", 30, 514), ("shared", 2, 8)),
    (("scaled_pass", 150, 64), ("shared", 1, 6)), (("smoothing_pass", 300, 64), ("global", 1, 3)),
    (("scaled_pass", 450, 514), ("global", 4, 2)), (("smoothing_pass", 450, 514), ("global", 4, 2)),
    (("scaled_pass", 237, 8), ("shared", 1, 4)), (("scaled_pass", 238, 8), ("global", 1, 4)),
    (("smoothing_pass", 236, 8), ("shared", 1, 4)), (("smoothing_pass", 237, 8), ("global", 1, 4)),
    (("scaled_pass", 1, 3), ("shared", 1, 1)), (("smoothing_pass", 513, 8), ("global", 1, 1)),
    (("scaled_pass", 150, MANY_WAVES), ("shared", 8, 6)), (("smoothing_pass", 30, MANY_WAVES), ("shared", 8, 8)),
    (("scaled_pass", 29024, 8), ("global", 1, 1)), (("smoothing_pass", 11609, 514), ("global", 1, 1)),
]


def _check_grouped_geometry(kernel, s, b, geometry):
    """What the dense instances' launch rule promises: the block fits; M in
    shared memory exactly when one utterance's block fits there; the fewest
    utterances a block that fit and whose blocks run in one wave at two an
    SM where two fit its shared memory (one where one does), else the most
    that fit;
    :func:`cuda_scan.grouped_slices` slices, whose (column group, slice)
    pairs the block's threads hold."""
    placement, n_utt, ks = geometry
    size = lambda pl, n: cuda_scan.grouped_smem_bytes(kernel, s, pl, n)  # noqa: E731
    assert size(placement, n_utt) <= cuda_scan.SMEM_LIMIT
    assert (placement == "shared") == (size("shared", 1) <= cuda_scan.SMEM_LIMIT)
    fits = [n for n in cuda_scan.GRP_UTTERANCES if size(placement, n) <= cuda_scan.SMEM_LIMIT] or [1]
    per_sm = lambda n: 2 if 2 * (size(placement, n) + 1024) <= cuda_scan.SMEM_SM else 1  # noqa: E731
    one_wave = [n for n in fits if -(-b // n) <= per_sm(n) * N_SM]
    assert n_utt == (min(one_wave) if one_wave else max(fits))
    assert ks == cuda_scan.grouped_slices(s) and 1 <= ks <= min(cuda_scan.GRP_MAX_SLICES, s)
    assert ks == 1 or -(-s // 4) * ks <= cuda_scan.GRP_THREADS


@pytest.mark.parametrize("case", GROUPED_GEOMETRIES, ids=lambda c: "%s_S%d_B%d" % c[0])
def test_dense_grouped_geometry(case):
    """The dense instances of K12 and K13 launch by fit and the batch size,
    in one place."""
    (kernel, s, b), want = case
    geometry = cuda_scan.dense_grouped_geometry(kernel, s, b, N_SM)
    assert geometry == want
    _check_grouped_geometry(kernel, s, b, geometry)
    assert cuda_scan.dense_placement(kernel, s) == geometry[0]


@pytest.mark.parametrize("kernel, parent", [("scaled_pass", 29024), ("smoothing_pass", 11609)])
def test_dense_grouped_geometry_takes_every_s_the_parent_took(kernel, parent):
    """Every S the per-utterance dense K12 ((2S + 64) floats in the global
    placement, to 29,024) and K13 ((5S + 64), to 11,609) took runs in the
    grouped design: each S gets a block that fits, in shared memory to its
    limit and in device memory above."""
    floats = 2 if kernel == "scaled_pass" else 5
    assert parent == max(s for s in range(1, 40000) if 4 * (floats * s + 64) <= cuda_scan.SMEM_LIMIT)
    for s in (*range(1, 600), *range(600, parent + 1, 97), parent):
        for b in (3, 514, MANY_WAVES):
            _check_grouped_geometry(kernel, s, b, cuda_scan.dense_grouped_geometry(kernel, s, b, N_SM))


@pytest.mark.parametrize("lens", [[5, 3, 5, 0, 7, 3, 3], [0, 0, 0, 0, 0], [9], list(range(13)), [4] * 6],
                         ids=["ragged", "all_zero", "one", "distinct", "equal"])
def test_group_order(lens):
    """The grouped kernels' row order: a permutation of the rows, longest
    first, equal lengths in row order (stable), its inverse exact; groups of
    n_utt consecutive rows, the last one short when B is not a multiple of
    n_utt, and all-zero-length rows grouped together at the end."""
    lens_t = torch.tensor(lens, dtype=torch.int32)
    order = cuda_scan.group_order(lens_t)
    assert order.dtype == torch.int32 and order.shape == (len(lens),)
    assert sorted(order.tolist()) == list(range(len(lens)))
    inverse = torch.empty_like(order)
    inverse[order.long()] = torch.arange(len(lens), dtype=torch.int32)
    assert torch.equal(order[inverse.long()], torch.arange(len(lens), dtype=torch.int32))
    assert torch.equal(lens_t[order.long()][inverse.long()], lens_t)
    sorted_lens = lens_t[order.long()].tolist()
    assert sorted_lens == sorted(lens, reverse=True)
    for i in range(len(lens) - 1):  # stable: ties keep their row order
        if sorted_lens[i] == sorted_lens[i + 1]:
            assert order[i] < order[i + 1]
    for n_utt in cuda_scan.GRP_UTTERANCES:
        groups = [order[i:i + n_utt].tolist() for i in range(0, len(lens), n_utt)]
        assert sum(map(len, groups)) == len(lens) and all(len(g) == n_utt for g in groups[:-1])
        zero = [g for g in groups if all(lens[r] == 0 for r in g)]
        assert groups[len(groups) - len(zero):] == zero
