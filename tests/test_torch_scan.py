"""The plain versions of the port's four phone-loop scan kernels against beer_tpu.

Each kernel of ``beer_tpu_torch/ops/cuda_scan.py`` has a plain PyTorch
version, which is what its wrapper runs on CPU tensors.  Held against:

* the Pallas TPU kernel it replaces, run with ``interpret=True``, in
  float32.  Interpret mode computes in float32 even under the suite's
  x64, so the tolerance is rtol 1e-5: the summation orders over S and
  P differ, and the Pallas kernel gathers the ξ rows/columns with a
  two-pass bf16 selection product (measured gap ~4e-6 relative here);
* the JAX general path (``forward_backward_probs``,
  ``expected_transition_counts_probs``, the XLA route of
  ``viterbi_banded``) in float64, to rtol 1e-9.

Shapes: U=4 units × 3 states, D=3 (P=6 reduced stats), B=4 with one
full, two ragged and one zero-length row, T=20.
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
from port_util import B, D, SPU, T, U, close, port_args as _port_args, scan_problem, t

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
    init_lm = jnp.broadcast_to(f32(pb["init"])[:, None], (S, B))
    final_lm = jnp.broadcast_to(f32(pb["final"])[:, None], (S, B))
    alphas, norms, last, logz = pallas_scan.forward_llh_ckpt_pass_lm(
        stats_lm, bands, init_lm, mask, interpret=True, w=f32(pb["w"]),
        bias=f32(pb["bias"]), store_alpha=True)
    sel_r = jax.nn.one_hot(pb["ends"], S, dtype=jnp.float32)
    sel_c = jax.nn.one_hot(pb["starts"], S, dtype=jnp.float32)
    acc2, counts, gamma0, xi = pallas_scan.phone_loop_estep_ckpt_acc_lm(
        None, None, bands, final_lm, mask, sel_r, sel_c, stats_lm, interpret=True,
        w=f32(pb["w"]), bias=f32(pb["bias"]), alphas=alphas, norms=norms)
    return dict(alphas=np.asarray(alphas), norms=np.asarray(norms)[:, 0],
                last=np.asarray(last), logz=np.asarray(logz), acc2=np.asarray(acc2),
                counts=np.asarray(counts), gamma0=np.asarray(gamma0), xi=np.asarray(xi))


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
                "viterbi_backtrace_banded"]


@pytest.mark.parametrize("kernel", KERNEL_NAMES)
def test_plain_version_matches_pallas_f32(kernel):
    pb = _problem()
    a = _port_args(pb, torch.float32)
    lens = pb["lengths"]
    full = lens > 0
    if kernel in ("forward_llh_banded", "estep_acc_banded"):
        ref = _pallas(pb)
        alpha, norms, last, logz = _port_forward(a)
        if kernel == "forward_llh_banded":
            for b in range(B):
                ln = lens[b]
                close(alpha[b, :ln], ref["alphas"][:ln, :, b], RTOL_F32, atol=1e-7)
                close(norms[b, :ln], ref["norms"][:ln, b], RTOL_F32)
                assert not alpha[b, ln:].any() and (norms[b, ln:] == 1).all()
            close(last, ref["last"].T, RTOL_F32, atol=1e-7)
            close(logz[full], ref["logz"][full], RTOL_F32)
            assert (logz[~full] == 0).all()
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
                gamma0=post[:, 0], xi=np.asarray(xi))


@pytest.mark.parametrize("kernel", KERNEL_NAMES)
def test_plain_version_matches_general_path_f64(kernel):
    pb = _problem(seed=11)
    a = _port_args(pb, torch.float64)
    ref = _general(pb)
    lens = pb["lengths"]
    full = lens > 0
    if kernel in ("forward_llh_banded", "estep_acc_banded"):
        alpha, norms, last, logz_base = _port_forward(a)
        log_z = logz_base + torch.log((last * a["final"]).sum(-1))
        if kernel == "forward_llh_banded":
            close(log_z[full], ref["log_z"][full], RTOL_F64)
            for b in np.flatnonzero(full):
                ln = lens[b]
                close(alpha[b, :ln], ref["alpha"][b, :ln], RTOL_F64, atol=1e-300)
                close(norms[b, :ln], ref["norms"][b, :ln], RTOL_F64)
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


@pytest.mark.parametrize("kernel", KERNEL_NAMES)
def test_wrapper_runs_plain_version_on_cpu(kernel):
    """On CPU tensors each wrapper is its plain version, and no launch is counted."""
    pb = _problem(seed=3)
    a = _port_args(pb, torch.float32)
    cuda_scan.reset_launch_counts()
    alpha, norms, last, logz = _port_forward(a)
    llh = (a["stats"] @ a["w"].T + a["bias"]).contiguous()
    lb, li, lf = (tss.log_bands(a[k]) for k in ("bands", "init", "final"))
    choices, exarg, alpha_last = cuda_scan.viterbi_fwd_banded_plain(llh, a["lens"], lb, li)
    cases = {
        "forward_llh_banded": (cuda_scan.forward_llh_banded, cuda_scan.forward_llh_banded_plain,
                               (a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["init"])),
        "estep_acc_banded": (cuda_scan.estep_acc_banded, cuda_scan.estep_acc_banded_plain,
                             (a["stats"], a["lens"], a["w"], a["bias"], a["bands"], a["final"],
                              alpha, norms, a["ends"], a["starts"])),
        "viterbi_fwd_banded": (cuda_scan.viterbi_fwd_banded, cuda_scan.viterbi_fwd_banded_plain,
                               (llh, a["lens"], lb, li)),
        "viterbi_backtrace_banded": (cuda_scan.viterbi_backtrace_banded,
                                     cuda_scan.viterbi_backtrace_banded_plain,
                                     (choices, exarg, alpha_last, lf)),
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
