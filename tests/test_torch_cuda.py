"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda`` and skipped where torch sees no CUDA device: a CUDA
kernel has no CPU mode.  The machine with the card has no JAX, and
``tests/conftest.py`` imports it, so run this file there without the
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances (float32; the kernels and the plain versions sum in
different orders): log Z rel 1e-5, α̂ and γ0 abs 1e-5, the reduced
statistics and ξ rel 1e-4 of their largest entry; the Viterbi kernels
do the same float adds and maxima as their plain versions, so their
outputs are equal.
"""

import numpy as np
import pytest
import torch

from beer_tpu_torch.ops import cuda_scan
from beer_tpu_torch.ops import semiring_scan as tss
from port_util import port_args, scan_problem

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

    llh = (a["stats"] @ a["w"].T + a["bias"]).contiguous()
    lb, li, lf = (tss.log_bands(a[k]).contiguous() for k in ("bands", "init", "final"))
    ch, ex, al = cuda_scan.viterbi_fwd_banded(llh, a["lens"], lb, li)
    ch_r, ex_r, al_r = cuda_scan.viterbi_fwd_banded_plain(llh, a["lens"], lb, li)
    assert torch.equal(ch, ch_r) and torch.equal(ex, ex_r) and torch.equal(al, al_r)
    paths, scores = cuda_scan.viterbi_backtrace_banded(ch, ex, al, lf)
    paths_r, scores_r = cuda_scan.viterbi_backtrace_banded_plain(ch, ex, al, lf)
    assert torch.equal(paths, paths_r) and torch.equal(scores, scores_r)
    assert all(k.launches == 1 for k in cuda_scan.KERNELS.values())


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
