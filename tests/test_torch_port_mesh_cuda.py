"""A trainer on a world-1 NCCL mesh on the card against one without a mesh.
Every test here is marked `cuda` and skips without a card; this file
imports no JAX:

    python -m pytest --noconftest tests/test_torch_port_mesh_cuda.py -q

A narrow InterpGN + Transformer at T = 300 (K1/K2 for the banks, K5/K6 for
attention, bf16 under amp) at dropout 0.1, on a one-process NCCL group
and `Mesh((1,), ("data",))`: the staged steps, whose graphs now hold the
all-reduces of the loss's weight sum, the gradients and the reported
loss, replay bit for bit as the trainer without a mesh (losses and
parameters after each step), and the warm-up and the capture launch the
kernels of a lone step.
"""

import numpy as np
import pytest
import torch

from sie_tpu_torch.config import Config
from sie_tpu_torch.ops.attention import attention_bwd, fused_attention
from sie_tpu_torch.ops.shapelet_l1 import (l1_sliding_distance,
                                           l1_sliding_distance_bwd)
from sie_tpu_torch.parallel import comm
from sie_tpu_torch.parallel.mesh import Mesh
from sie_tpu_torch.parallel.multihost import free_port
from sie_tpu_torch.train.trainer import Trainer

pytestmark = pytest.mark.cuda

KW = dict(model="InterpGN", dnn_type="Transformer", seq_len=300, enc_in=8,
          num_class=3, num_shapelet=2, d_model=64, d_ff=128, n_heads=2,
          e_layers=1, amp=True, lr=5e-3, dropout=0.1, seed=0)
B, ROWS, STEPS = 16, 64, 5
KERNELS = {"K1": l1_sliding_distance, "K2": l1_sliding_distance_bwd,
           "K5": fused_attention, "K6": attention_bwd}


@pytest.fixture
def nccl_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL and CUDA graphs")
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0,
                            device_id=dev)
    try:
        yield Mesh((1,), ("data",))
    finally:
        dist.destroy_process_group()


def test_world_one_mesh_replays_equal_the_trainer_without_a_mesh(nccl_mesh):
    rng = np.random.default_rng(0)
    rows = type("Rows", (), dict(
        x=rng.normal(size=(ROWS, KW["seq_len"], KW["enc_in"])).astype(
            np.float32),
        y=rng.integers(0, KW["num_class"], ROWS).astype(np.int32),
        padding_mask=np.ones((ROWS, KW["seq_len"]), np.float32)))()
    steps = [(rng.permutation(ROWS)[:B], np.ones(B, np.float32))
             for _ in range(STEPS)]
    cfg = Config(**KW)
    trainers = [Trainer(cfg, STEPS, device="cuda", mesh=m,
                        generator=torch.Generator().manual_seed(0))
                for m in (None, nccl_mesh)]
    devs = [t.device_data("train", rows) for t in trainers]
    staged = [t.stage_steps(steps, 1.0) for t in trainers]
    reduces = []
    real = comm.all_reduce_

    def counted(t, group):
        reduces.append(tuple(t.shape))
        return real(t, group)

    for k in range(STEPS):
        out = []
        for i, t in enumerate(trainers):
            for fn in KERNELS.values():
                fn.launches = 0
            comm.all_reduce_ = counted
            try:
                loss, _ = t.train_step_staged(devs[i], staged[i], k)
            finally:
                comm.all_reduce_ = real
            launches = {name: fn.launches for name, fn in KERNELS.items()}
            live = 1 if k < 2 else 0     # warm-up and capture; replays
            assert launches == {"K1": 6 * live, "K2": 6 * live, "K5": live,
                                "K6": live}, (k, i)
            out.append(float(loss))
        assert out[0] == out[1], k
        for (name, p), q in zip(trainers[0].model.named_parameters(),
                                trainers[1].model.parameters()):
            assert torch.equal(p, q), (k, name)
    # the mesh trainer's warm-up and capture each issued the weight sums
    # of the two loss heads, the gradient sum and the reported loss
    assert len(reduces) == 8
    assert len(trainers[1].captures) == 1
