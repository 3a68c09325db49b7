"""The registered ops `sie_tpu_torch::l1_fwd`, `l1_grouped_fwd` and
`attention_fwd` on the card: their CUDA implementations launch the
kernels (counted) and agree with the plain versions; an exported program
of a narrow InterpGN + Transformer runs them on the card and equals the
live predictor; and a CUDA graph captured through the ops (forward and
backward) replays bit-equal to eager. Every test is marked `cuda` and
skips without a card; this file imports no JAX:

    python -m pytest --noconftest tests/test_torch_port_ops_cuda.py -q
"""

import numpy as np
import pytest
import torch

from sie_tpu_torch.config import Config
from sie_tpu_torch.ops.attention import (attention_lse_plain, attention_plain,
                                         fused_attention)
from sie_tpu_torch.ops.shapelet_l1 import (l1_sliding_distance,
                                           l1_sliding_distance_grouped,
                                           l1_sliding_distance_plain)

pytestmark = pytest.mark.cuda
OPS = torch.ops.sie_tpu_torch
K1_TOL = 1e-4                    # f32, summation order
K5_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
SERVE_TOL = 5e-2                 # bf16 logits


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _normal(seed, *shapes, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
            for s in shapes]


def test_ops_launch_the_kernels(card):
    x, s1, s2 = _normal(0, (4, 6, 200), (5, 6, 10), (3, 6, 40))
    xc, s1c, s2c = x.to(card), s1.to(card), s2.to(card)
    before = l1_sliding_distance.launches
    got = OPS.l1_fwd(xc, s1c, "euclidean")
    assert l1_sliding_distance.launches == before + 1
    torch.testing.assert_close(got.cpu(), l1_sliding_distance_plain(x, s1),
                               rtol=0, atol=K1_TOL)
    before = l1_sliding_distance_grouped.launches
    got = OPS.l1_grouped_fwd(xc, [s1c, s2c])
    assert l1_sliding_distance_grouped.launches == before + 1
    for g, s in zip(got, (s1, s2)):
        torch.testing.assert_close(g.cpu(), l1_sliding_distance_plain(x, s),
                                   rtol=0, atol=K1_TOL)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _normal(1, *[(4, 300, 64)] * 3, dtype=dtype)
        before = fused_attention.launches
        out, lse = OPS.attention_fwd(q.to(card), k.to(card), v.to(card),
                                     0.125, 0.0, None, True)
        assert fused_attention.launches == before + 1
        torch.testing.assert_close(
            out.float().cpu(), attention_plain(q, k, v, 0.125).float(),
            rtol=0, atol=K5_TOL[dtype])
        torch.testing.assert_close(lse.cpu(),
                                   attention_lse_plain(q, k, 0.125),
                                   rtol=0, atol=1e-3)


def test_exported_program_runs_the_kernels(card, tmp_path):
    from sie_tpu_torch.models.registry import build_model
    from sie_tpu_torch.serve import CompiledPredictor, Predictor
    cfg = Config(model="InterpGN", dnn_type="Transformer", seq_len=300,
                 enc_in=8, num_class=3, num_shapelet=2, d_model=64, d_ff=128,
                 n_heads=2, e_layers=1, amp=True, seed=0)
    live = Predictor.from_module(
        cfg, build_model(cfg, card, torch.Generator().manual_seed(0)),
        device=card, max_batch=8)
    live.export_stablehlo(str(tmp_path), batch_sizes=(8,))
    cp = CompiledPredictor(str(tmp_path))
    assert "torch.ops.sie_tpu_torch.attention_fwd" in \
        cp.programs[8].graph_module.code
    x = np.random.default_rng(2).normal(size=(5, 300, 8)).astype(np.float32)
    before = l1_sliding_distance.launches, fused_attention.launches
    got = cp.predict(x)
    assert (l1_sliding_distance.launches - before[0],
            fused_attention.launches - before[1]) == (6, 1)
    want = live.predict(x)
    np.testing.assert_allclose(got.logits, want.logits, atol=SERVE_TOL)
    np.testing.assert_array_equal(got.classes, want.classes)


@pytest.mark.parametrize("dnn", ["TimesNet", "PatchTST"])
def test_timesnet_and_patchtst_programs_on_the_card(card, tmp_path, dnn):
    """InterpGN + TimesNet (the period gather and the FFT on the card) and
    + PatchTST through torch.export: the program serves the live
    predictor's logits, K1 launched from the graph."""
    from sie_tpu_torch.models.registry import build_model
    from sie_tpu_torch.serve import CompiledPredictor, Predictor
    cfg = Config(model="InterpGN", dnn_type=dnn, seq_len=300, enc_in=8,
                 num_class=3, num_shapelet=2, d_model=32, d_ff=32,
                 n_heads=2, e_layers=1, top_k=3, num_kernels=3,
                 patch_chunk_rows=16, amp=True, seed=0)
    live = Predictor.from_module(
        cfg, build_model(cfg, card, torch.Generator().manual_seed(0)),
        device=card, max_batch=8)
    live.export_stablehlo(str(tmp_path), batch_sizes=(8,))
    cp = CompiledPredictor(str(tmp_path))
    x = np.random.default_rng(3).normal(size=(8, 300, 8)).astype(np.float32)
    before = l1_sliding_distance.launches
    got = cp.predict(x)
    assert l1_sliding_distance.launches - before == 6
    want = live.predict(x)
    np.testing.assert_allclose(got.logits, want.logits, atol=SERVE_TOL)
    np.testing.assert_array_equal(got.classes, want.classes)


def test_graph_capture_through_the_ops(card):
    x, s = _normal(3, (4, 6, 300), (5, 6, 30))
    q, k, v = _normal(4, *[(4, 300, 64)] * 3, dtype=torch.bfloat16)
    x, s, q, k, v = (t.to(card) for t in (x, s, q, k, v))
    s.requires_grad_(True)
    for t in (q, k, v):
        t.requires_grad_(True)
    params = (s, q, k, v)

    def step():
        for p in params:
            p.grad = None
        loss = l1_sliding_distance(x, s).square().mean() + \
            fused_attention(q, k, v, 0.125).float().square().mean()
        loss.backward()
        return loss.detach(), [p.grad.clone() for p in params]

    eager_loss, eager_grads = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()                                     # warm-up on the stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        loss, grads = step()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(loss, eager_loss)
    for g, e in zip(grads, eager_grads):
        assert torch.equal(g, e)
