"""Model and sub-model configuration, the port's own copy.

Ports ``MoEConfig``, ``SSMConfig``, ``MLAConfig``, ``ModelConfig`` (with
``n_params`` and ``n_active_params``), ``ShapeConfig``, ``INPUT_SHAPES``,
``SubmodelConfig``, ``RunConfig``, ``list_archs``, ``_shrink``,
``get_config`` and ``get_reduced_config`` of ``repro/configs/base.py``.  Field names and defaults are the reference's,
so one config means the same model in both packages, and the registry
holds the reference's ten language-model architectures.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden width
    n_shared: int = 0              # shared (always-on) experts
    router: str = "softmax"        # "softmax" (mixtral) | "sigmoid"
    capacity_factor: float = 1.25  # dispatch capacity factor
    aux_loss_weight: float = 0.01  # load-balance loss weight


@dataclass(frozen=True)
class SSMConfig:
    d_state: int                   # SSD state size N
    head_dim: int = 64             # P
    n_heads: int = 0               # derived if 0: expand*d_model // head_dim
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256               # SSD chunk length


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64        # decoupled rope dims (shared k_rope)
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # derived if 0: d_model // n_heads
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    pos_embed: str = "rope"        # rope | sinusoidal | none
    qk_norm: bool = False
    sliding_window: int = 0        # 0 = full attention
    tie_embeddings: bool = False
    act: str = "silu"
    moe: Optional[MoEConfig] = None
    n_dense_layers: int = 0        # leading dense layers before MoE layers
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    hybrid: bool = False           # parallel attn + ssm heads per layer
    mtp: bool = False              # multi-token-prediction block
    n_codebooks: int = 0           # audio: codebook token streams
    vision_stub: bool = False      # vlm: patch-embedding frontend
    vision_d: int = 1024           # stub patch-embedding width
    vision_patches: int = 256      # patches prepended in train/prefill
    source: str = ""               # citation

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks), the
        reference's formula."""
        D, F, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        hd = self.head_dim
        n = V * D * (1 if self.tie_embeddings else 2)
        if self.n_codebooks:
            n += self.n_codebooks * V * D  # extra heads
        per = 0
        if not self.attn_free:
            if self.mla is not None:
                m = self.mla
                qh = m.nope_head_dim + m.rope_head_dim
                per += D * m.q_lora_rank + m.q_lora_rank * self.n_heads * qh
                per += D * (m.kv_lora_rank + m.rope_head_dim)
                per += m.kv_lora_rank * self.n_heads * (m.nope_head_dim
                                                        + m.v_head_dim)
                per += self.n_heads * m.v_head_dim * D
            else:
                per += D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd
                per += self.n_heads * hd * D
        if self.ssm is not None:
            s = self.ssm
            nh = s.n_heads or (s.expand * D) // s.head_dim
            d_in = nh * s.head_dim
            per += D * (2 * d_in + 2 * s.d_state * nh + nh) + d_in * D
            per += s.conv_width * (d_in + 2 * s.d_state * nh)
        if self.moe is not None:
            mo = self.moe
            n_moe = L - self.n_dense_layers
            per_moe = ((mo.n_experts + mo.n_shared) * 3 * D * mo.d_ff
                       + D * mo.n_experts)
            n += n_moe * per_moe + self.n_dense_layers * 3 * D * F
            n += L * per + 2 * L * D
            return n
        if F:
            per += 3 * D * F
        n += L * per + 2 * L * D
        return n

    def n_active_params(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.n_params()
        mo = self.moe
        full = self.n_params()
        n_moe = self.n_layers - self.n_dense_layers
        all_e = (mo.n_experts + mo.n_shared) * 3 * self.d_model * mo.d_ff
        act_e = (mo.top_k + mo.n_shared) * 3 * self.d_model * mo.d_ff
        return full - n_moe * (all_e - act_e)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class SubmodelConfig:
    """Configuration of distributed sub-model training (Alg. 1 / Alg. 2):
    which semantic ``axes`` are windowed, the per-axis ``capacity``, the
    selection ``scheme``, K ``local_steps``, C ``clients_per_round`` and
    the client/server learning rates.  Same fields and defaults as
    ``repro.configs.base.SubmodelConfig``."""

    scheme: str = "rolling"        # rolling | random | static | full
    capacity: float = 0.5          # beta: fraction of each maskable axis
    axes: Tuple[str, ...] = ("d_ff", "heads", "kv_heads", "experts",
                             "ssm_heads", "moe_d_ff")
    local_steps: int = 2           # K
    clients_per_round: int = 16    # C
    client_lr: float = 0.05        # eta
    server_lr: float = 1.0
    proj_radius: float = 0.0       # W: l2 projection radius (0 = off)
    seed: int = 0
    wrap: bool = False
    align: int = 1                 # round window sizes/offsets to multiples
    stagger: bool = False          # rolling: rotate window per client
    shared_window: Optional[bool] = None


@dataclass(frozen=True)
class RunConfig:
    """One dry-run: an architecture, an input shape, the sub-model plan.
    ``remat`` and ``fsdp`` have no effect in the port: it keeps every
    activation for the backward (no rematerialisation), and a rank holds
    whole params (the reference's sharding constraints are no-ops here,
    ROADMAP.md A12); each dry-run record says so under ``notes``."""

    arch: str
    shape: str
    submodel: SubmodelConfig = SubmodelConfig()
    dtype: str = "bfloat16"
    remat: bool = True
    fsdp: bool = True              # no effect in the port (see above)
    multi_pod: bool = False


ARCHS = ["deepseek_v3_671b", "tinyllama_1_1b", "mamba2_130m",
         "musicgen_large", "qwen3_14b", "deepseek_7b", "mixtral_8x22b",
         "qwen3_32b", "phi_3_vision_4_2b", "hymba_1_5b"]

_ALIAS = {a.replace("_", "-"): a for a in ARCHS}


def _module(arch: str):
    arch = _ALIAS.get(arch, arch).replace("-", "_")
    if arch not in ARCHS:
        raise ValueError(f"unknown architecture {arch!r}; the registry "
                         f"holds {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    """CPU smoke-test variant: <=2 layers, d_model<=256, <=4 experts."""
    return _module(arch).reduced()


def list_archs():
    return [a for a in ARCHS if a != "resnet18_cifar"]


def _shrink(cfg: ModelConfig, **over) -> ModelConfig:
    """Generic reduction preserving the family structure (the
    reference's rule)."""
    base = dict(
        n_layers=2,
        d_model=min(cfg.d_model, 256),
        n_heads=min(cfg.n_heads, 8),
        n_kv_heads=min(cfg.n_kv_heads, 4),
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab=min(cfg.vocab, 512),
        head_dim=32,
        vision_patches=min(cfg.vision_patches, 16),
        vision_d=min(cfg.vision_d, 64),
    )
    if cfg.moe is not None:
        base["moe"] = replace(cfg.moe, n_experts=min(cfg.moe.n_experts, 4),
                              top_k=min(cfg.moe.top_k, 2),
                              d_ff=min(cfg.moe.d_ff, 256))
        base["n_dense_layers"] = min(cfg.n_dense_layers, 1)
    if cfg.ssm is not None:
        base["ssm"] = replace(cfg.ssm, d_state=min(cfg.ssm.d_state, 16),
                              head_dim=32, chunk=32)
    if cfg.mla is not None:
        base["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=64,
                                rope_head_dim=16, nope_head_dim=32,
                                v_head_dim=32)
    base.update(over)
    return replace(cfg, name=cfg.name + "-reduced", **base)
