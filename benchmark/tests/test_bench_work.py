"""The counts of operations and bytes, against small shapes worked by
hand, and the idle-share arithmetic on made-up intervals."""

import pytest

from benchmark import peaks
from benchmark.trace import DeviceTrace, Spans
from benchmark.work import attention, interpgn, l1


def test_l1_counts_by_hand():
    # B 2, C 3, T 10, n 4, L 5, stride 1: W = 6 windows, 2*4*3*6*5 = 720
    # taps of two flops
    flops, nbytes, unit = l1.forward(2, 3, 10, 4, 5, 1)
    assert (flops, unit) == (1440, "fp32")
    assert nbytes == 4 * (2 * 3 * 10 + 4 * 3 * 5 + 2 * 4 * 3 * 6)
    flops, nbytes, _ = l1.backward(2, 3, 10, 4, 5, 1)
    assert flops == 1440
    assert nbytes == 4 * (2 * 3 * 10 + 2 * 4 * 3 * 5 + 2 * 4 * 3 * 6)


def test_l1_strided_windows():
    # T 17984, L 900, stride 9 (EigenWorms' first bank): 1899 windows
    assert l1.windows(17984, 900, 9) == 1899
    assert l1.taps(1, 1, 17984, 1, 900, 9) == 1899 * 900


def test_attention_counts_by_hand():
    # BH 2, T 3, dk 4: forward 4*2*9*4 = 288 flops, bf16 reads Q, K, V
    # and writes O: 2 bytes * 4 * 2 * 3 * 4
    assert attention.forward(2, 3, 4, True) == (288, 192, "bf16")
    assert attention.backward(2, 3, 4, True) == (720, 384, "bf16")
    # float32 on the tensor cores as three TF32 products; the long-T
    # kernels (K7, K8a, K8b) count the same work as K5/K6
    assert attention.forward(2, 3, 4, False) == (288, 384, "f32_tc")


def test_flagship_bounds_match_the_kernel_table():
    # PERF.md's kernel table: K1 1.5356 ms (six flagship banks), K5 bf16
    # 0.0946 ms at BH 512, T 845, dk 64
    cfg = {"seq_len": 845, "enc_in": 122, "num_shapelet": 10,
           "shapelet_lengths": [0.05, 0.1, 0.2, 0.3, 0.5, 0.8]}
    k1 = sum(peaks.least_s(f, b, u) for g, f, b, u in
             interpgn.l1_groups(dict(cfg, amp=True), 64, False))
    assert k1 * 1e3 == pytest.approx(1.5356, rel=2e-3)
    k5 = peaks.least_s(*attention.forward(512, 845, 64, True))
    assert k5 * 1e3 == pytest.approx(0.0946, rel=2e-3)


def test_step_groups_by_hand():
    cfg = {"seq_len": 4, "enc_in": 2, "num_class": 3, "num_shapelet": 1,
           "shapelet_lengths": [0.5], "d_model": 2, "n_heads": 1,
           "e_layers": 1, "d_ff": 4, "amp": True, "dnn_type": "Transformer"}
    groups = {}
    for g, f, b, u in interpgn.train_step(cfg, 1):
        f0, b0 = groups.get(g, (0, 0))
        groups[g] = (f0 + f, b0 + b)
    # bank: L 3 (the floor), W 2, taps 1*1*2*2*3 = 12 a pass
    assert groups["l1"][0] == 2 * 12 * 2
    # products a row (T 4): layer 2*4*(4*4 + 2*2*4) = 256, head
    # 2*4*2*3 = 48, SBM head 2*2*3 = 12, embedding 2*4*6*2 = 96;
    # backward twice each, the embedding once
    assert groups["gemm"][0] == 3 * (256 + 48 + 12) + 2 * 96
    assert groups["attention"][0] == 14 * 1 * 16 * 2
    # straight-through chain: 1 row * 1 * 2 channels * 2 windows, 8 bytes
    assert groups["ste"][1] == 8 * 4
    # parameters: bank 6, SBM head 6, conv 12, 4 projections of 6, two
    # LayerNorms of 4, FFN 12 + 10, final LayerNorm 4, head 27
    assert groups["optimizer"][1] == 28 * (6 + 6 + 12 + 24 + 8 + 22 + 4
                                           + 27)


def test_fcn_step_groups_by_hand():
    cfg = {"seq_len": 20, "enc_in": 2, "num_class": 3, "num_shapelet": 1,
           "shapelet_lengths": [0.5], "amp": False, "dnn_type": "FCN"}
    groups = {g: (f, b, u) for g, f, b, u in interpgn.train_step(cfg, 1)
              if g in ("gemm", "conv", "optimizer")}
    # VALID convolutions of 8, 5, 3 taps: 13, 9, 7 steps out, two flops
    # a tap: 2*13*2*128*8, 2*9*128*256*5, 2*7*256*128*3; backward twice
    # each, the first convolution's once; float32 products as three TF32
    # products
    conv1 = 2 * 13 * 2 * 128 * 8
    rest = 2 * 9 * 128 * 256 * 5 + 2 * 7 * 256 * 128 * 3
    assert groups["conv"] == (3 * rest + 2 * conv1, 0.0, "f32_tc")
    # head 2*128*3, SBM head (2 features) 2*2*3, backward twice each
    assert groups["gemm"] == (3 * (2 * 128 * 3 + 12), 0.0, "f32_tc")
    # parameters: bank 1*2*10, SBM head 3*2, convolutions with biases
    # 128*2*8 + 128, 256*128*5 + 256, 128*256*3 + 128, three BatchNorms'
    # scales and biases 2*(128 + 256 + 128), head 128*3 + 3
    n = (20 + 6 + 128 * 16 + 128 + 256 * 640 + 256 + 128 * 768 + 128
         + 2 * 512 + 387)
    assert groups["optimizer"][1] == 28 * n
    assert not [g for g in interpgn.train_step(cfg, 1) if g[0] == "attention"]


def _trace(kernels, window):
    t = DeviceTrace()
    t.kernels, t.window = kernels, window
    return t


def test_idle_share_on_made_up_intervals():
    # busy [10, 30) and [20, 40) overlap: their union is 30 ns; [50, 60)
    # adds 10; [90, 120) is cut at the window's end, 100
    t = _trace([("a", 10, 30), ("b", 20, 40), ("a", 50, 60),
                ("c", 90, 120)], (0, 100))
    assert t.busy_s() == pytest.approx(50e-9)
    assert t.window_s == pytest.approx(100e-9)
    assert t.seconds_where(lambda n: n == "a") == pytest.approx(30e-9)
    assert t.seconds_where(lambda n: n == "z") is None
    assert dict(t.top_ops()) == {"a": pytest.approx(30e-9),
                                 "b": pytest.approx(20e-9),
                                 "c": pytest.approx(30e-9)}


def test_idle_gaps_by_host_span():
    t = _trace([("k", 10, 20), ("k", 60, 100)], (0, 100))
    spans = Spans()
    spans.add("outer", 0, 100)
    spans.add("stage_steps", 30, 55)
    gaps = dict(t.idle_gaps(spans))
    # gap [20, 60) has its middle at 40, inside stage_steps; gap [0, 10)
    # inside only the outer span
    assert gaps["stage_steps (1 gaps)"] == pytest.approx(40e-9)
    assert gaps["outer (1 gaps)"] == pytest.approx(10e-9)
