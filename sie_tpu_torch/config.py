"""Typed configuration for sie_tpu_torch.

A field-for-field copy of the JAX package's `Config`, so one `config.json`
reads in both packages. Only `compute_dtype` differs: it returns a torch
dtype. The port keeps its own copy rather than importing the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class Config:
    # ===== data selection =====
    data: str = "EEG3"                # 'EEG' (39-class) | 'EEG3' | 'UEA' | 'Monash'
    data_root: str = "./data"
    json_path: str = "./data/textmaps.json"
    dataset: str = "BasicMotions"     # UEA/Monash dataset name
    task_name: str = "classification"  # 'classification' | 'regression'

    # ===== EEG data params =====
    target_channels: int = 122
    target_timepoints: int = 1651
    max_files: int = 1000
    max_subjects: int = 5
    subject_id: str = "sub-01"
    subject_ids: Tuple[str, ...] = ("sub-01", "sub-02", "sub-03")
    task_type: str = "imagine"        # 'imagine' | 'read' | 'both'
    synthetic_trials: int = 0
    test_size: float = 0.2
    val_size: float = 0.1
    normalizer: str = "standardization"

    # ===== model selection =====
    model: str = "InterpGN"           # 'SBM' | 'LTS' | 'InterpGN' | 'DNN' | 'EEGCNN'
    dnn_type: str = "Transformer"     # 'FCN' | 'Transformer' | 'TimesNet' | 'PatchTST' | 'ResNet'

    # ===== SBM / InterpGN hyperparams =====
    lambda_reg: float = 0.1
    lambda_div: float = 0.1
    epsilon: float = 1.0
    num_shapelet: int = 10
    gating_value: Optional[float] = None
    pos_weight: bool = False
    sbm_cls: str = "linear"           # 'linear' | 'bilinear' | 'attention'
    distance_func: str = "euclidean"  # 'euclidean' (mean-|diff|) | 'sqeuclidean' | 'cosine' | 'pearson'
    beta_schedule: str = "constant"   # 'cosine' | 'linear' | 'constant'
    memory_efficient: bool = False
    shapelet_lengths: Tuple[float, ...] = (0.05, 0.1, 0.2, 0.3, 0.5, 0.8)

    # ===== EEGCNN params =====
    eegcnn_layers: int = 2
    eegcnn_pooling: Optional[str] = "mean"  # None | 'mean' | 'sum' | 'top'
    eegcnn_cnn_f1: int = 8
    eegcnn_cnn_f2: int = 8
    eegcnn_kernel1: int = 125
    eegcnn_kernel2: int = 25
    eegcnn_pool1: int = 2
    eegcnn_pool2: int = 5
    eegcnn_dropout1: float = 0.1
    eegcnn_dropout2: float = 0.1
    eegcnn_n_heads: int = 8
    eegcnn_d_ff: int = 256

    # ===== trainer =====
    lr: float = 5e-3
    lr_decay: bool = False
    lr_warmup_epochs: float = 0.0
    gradient_accumulation_steps: int = 1
    gradient_clip: float = 0.0
    batch_size: int = 64
    log_interval: int = 20
    min_epochs: int = 0
    train_epochs: int = 500
    num_workers: int = 0
    patience: int = 50
    multi_gpu: bool = False
    test_only: bool = False
    seed: int = -1
    amp: bool = True                  # bf16 compute policy

    # ===== DNN backbone configs =====
    top_k: int = 5
    num_kernels: int = 6
    patch_chunk_rows: int = 0
    patch_remat: bool = True
    enc_in: int = 7
    dec_in: int = 7
    c_out: int = 7
    d_model: int = 512
    n_heads: int = 8
    e_layers: int = 2
    d_layers: int = 1
    d_ff: int = 2048
    moving_avg: int = 25
    factor: int = 1
    distil: bool = True
    dropout: float = 0.0
    activation: str = "gelu"
    output_attention: bool = False
    embed: str = "timeF"
    freq: str = "h"
    label_len: int = 48
    pred_len: int = 96
    seasonal_patterns: str = "Monthly"
    inverse: bool = False

    # ===== task-branch params =====
    features: str = "M"
    target: str = "OT"
    mask_rate: float = 0.25
    anomaly_ratio: float = 1.0

    # ===== data-derived (injected by the experiment) =====
    seq_len: int = 845
    num_class: int = 3
    original_fs: int = 500
    target_fs: int = 256

    # ===== accelerator-specific =====
    mesh_shape: Tuple[int, ...] = ()
    mesh_axes: Tuple[str, ...] = ("data", "model")
    use_pallas: bool = True            # JAX package only; the port always
    # routes CUDA tensors through its kernels
    use_flash_attention: bool = False
    attention_variant: str = "full"    # full | ds | prob | lsh
    use_fused_attention: bool = True   # fused attention kernel (K5)
    fused_attention_max_len: int = 4096  # T above this uses plain attention;
    # 0 = unlimited
    fused_attention_min_len: int = 256  # T below this uses plain attention;
    # 0 = always use the kernel
    augment: Tuple[str, ...] = ()
    augment_noise_std: float = 0.1
    augment_scale_std: float = 0.1
    augment_chdrop_prob: float = 0.1
    augment_tshift_max: int = 16
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_top_k: int = 1
    moe_aux_weight: float = 0.01
    fuse_short_banks: bool = False     # stride-1 'euclidean' shapelet banks
    # in one grouped launch (K3 forward, K4 backward) instead of one K1/K2
    # launch each; the same distances and gradients, bit for bit
    checkpoint_dir: str = "./checkpoints"
    result_dir: str = "./result"
    cache_dir: str = "./cache"
    stream_from_disk: bool = False
    scan_epoch: bool = False
    scan_eval: bool = True

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    # --- derived helpers -------------------------------------------------
    @property
    def num_shapelets_per_bank(self) -> Tuple[int, ...]:
        return (self.num_shapelet,) * len(self.shapelet_lengths)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.amp else torch.float32

    def checkpoint_key(self) -> str:
        return (
            f"{self.model}/{self.dataset}/"
            f"dnn-{self.dnn_type}_seed-{self.seed}_k-{self.num_shapelet}"
            f"_div-{self.lambda_div}_reg-{self.lambda_reg}_eps-{self.epsilon}"
            f"_beta-{self.beta_schedule}_dfunc-{self.distance_func}_cls-{self.sbm_cls}"
        )


DEFAULT_SEEDS = (0, 42, 1234, 8237, 2023)   # run.py's seeds without --seed


def config_to_json(cfg: Config) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=1)


def config_from_json(text: str) -> Config:
    """Unknown keys are ignored (forward compatibility); JSON lists become
    tuples."""
    raw = json.loads(text)
    names = {f.name for f in dataclasses.fields(Config)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in raw.items() if k in names}
    return Config(**kw)
