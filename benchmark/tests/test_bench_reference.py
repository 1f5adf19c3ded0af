"""The plain reference (`benchmark/reference/`) is a frozen copy of the
port's plain paths: on the CPU, in float32, it builds the same start from
the same seed and steps both cells' ticks as the port does (bit for bit
when the copy was made; to float32 rounding here, so that a later change
of the port that only reorders its arithmetic does not fail it)."""

import torch

from benchmark import compare, harness
from benchmark.drivers import ci, convex

CPU = torch.device("cpu")


def _close(a, b):
    la, lb = compare.leaves(a), compare.leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        if la[k].dtype.is_floating_point:
            torch.testing.assert_close(la[k], lb[k], rtol=1e-5, atol=1e-6,
                                       msg=k)
        else:
            assert torch.equal(la[k], lb[k]), k


def test_convex_tick_is_the_ports():
    cfg = harness.cell_spec("go1_convex.sweep_b65536")["config"]
    port, plain = convex._port(cfg, CPU), convex._plain(cfg, CPU,
                                                        torch.float32)
    (lp, pbp), (lr, pbr) = port.init(6, 2 ** 31 + 3), plain.init(6, 2 ** 31
                                                                 + 3)
    _close(lp, lr)
    wp = wr = torch.zeros((6, 120))
    for k in range(3):
        lp, lr = (convex._command(x, int(k > 0), 0.15) for x in (lp, lr))
        lp, wp = port.tick(lp, wp, pbp)
        lr, wr = plain.tick(lr, wr, pbr)
        _close({"loop": lp, "warm": wp}, {"loop": lr, "warm": wr})


def test_ci_tick_is_the_ports():
    spec = harness.cell_spec("a1_ci.b4096")
    cfg, trf = spec["config"], spec["traffic"]
    port = ci._side(cfg, trf, CPU, torch.float32, True)
    plain = ci._side(cfg, trf, CPU, torch.float32, False)
    sp, sr = port.init(4, 2 ** 31 + 5), plain.init(4, 2 ** 31 + 5)
    _close(sp, sr)
    t = torch.zeros(())
    for _ in range(2):
        sp, sr = port.tick(sp, t), plain.tick(sr, t)
        _close(sp, sr)
        t = t + 0.01
