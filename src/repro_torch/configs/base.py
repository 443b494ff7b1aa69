"""Config system: one dataclass family covering all assigned architectures.

Port of ``repro/configs/base.py``: the same fields, defaults, checks and
parameter count; ``dtype_of`` returns a ``torch.dtype``. Every
architecture file in this package exports ``CONFIG: ModelConfig`` with the
exact assigned dimensions, plus ``smoke_config()`` returning a reduced
variant (<=2 layers, d_model<=512, <=4 experts) for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8            # routed experts
    num_shared_experts: int = 0     # always-on experts (DeepSeek style)
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01   # load-balance loss coefficient


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block hyperparameters."""
    d_state: int = 128
    head_dim: int = 64              # SSD head dim (P)
    expand: int = 2                 # d_inner = expand * d_model
    n_groups: int = 8               # B/C groups (shardable)
    chunk_size: int = 256           # SSD chunk length
    conv_width: int = 4


@dataclass(frozen=True)
class AttentionConfig:
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 0               # 0 -> d_model // num_heads
    rope_theta: float = 10_000.0
    # Sliding window: 0 = full attention. For alternating patterns,
    # layer_pattern controls which layers are local.
    window: int = 0
    logit_softcap: float = 0.0      # gemma2-style attention softcap (0 = off)
    # MLA (DeepSeek / MiniCPM3 latent attention)
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0            # 0 -> no q compression
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio | mlp
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # Alternating local/global attention: period p with `global_every`
    # meaning layer i is GLOBAL iff (i % p) == p-1. "" = uniform.
    layer_pattern: str = ""         # e.g. "local:global" period via fields below
    local_global_period: int = 0    # 0 = all layers per attention.window
    # hybrid (zamba2): shared attention block applied every N mamba layers
    hybrid_attn_every: int = 0
    # enc-dec (whisper)
    num_encoder_layers: int = 0
    encoder_seq_len: int = 0        # stub frontend frames (whisper: 1500)
    # vlm: number of stub image-patch embeddings prepended
    num_image_tokens: int = 0
    final_logit_softcap: float = 0.0
    gated_mlp: bool = True          # SwiGLU (3 mats) vs GELU MLP (2 mats)
    # §Perf: flash-decoding partial-softmax over a length-sharded KV cache
    # (0 = off -> all-gather decode attention). See attention.py.
    decode_sharded_chunks: int = 0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = True
    source: str = ""                # citation

    @property
    def head_dim(self) -> int:
        a = self.attention
        if a is None:
            return 0
        return a.head_dim if a.head_dim else self.d_model // a.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic mechanism available (SSM, hybrid, or sliding window)."""
        if self.family in ("ssm", "hybrid"):
            return True
        a = self.attention
        if a is None:
            return False
        return a.window > 0 or self.local_global_period > 0

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path

    def param_count(self) -> int:
        """Analytic parameter count (matches init exactly; used for rooflines)."""
        d = self.d_model
        n = 0
        n += self.vocab_size * d                       # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d
        per_layer = 0
        if self.family == "ssm" or self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            conv_dim = d_in + 2 * s.n_groups * s.d_state
            per_layer += d * (2 * d_in + 2 * s.n_groups * s.d_state + nheads)  # in_proj
            per_layer += s.conv_width * conv_dim       # conv1d
            per_layer += nheads * 2                    # A_log, D
            per_layer += nheads                        # dt_bias
            per_layer += d_in * d                      # out_proj
            per_layer += d                             # norm
            per_layer += d_in                          # gated rmsnorm
        if self.attention is not None and self.family != "ssm":
            a = self.attention
            hd = self.head_dim
            if a.use_mla:
                qd = a.qk_nope_dim + a.qk_rope_dim
                if a.q_lora_rank:
                    per_layer += d * a.q_lora_rank + a.q_lora_rank * a.num_heads * qd
                    per_layer += a.q_lora_rank         # q norm
                else:
                    per_layer += d * a.num_heads * qd
                per_layer += d * (a.kv_lora_rank + a.qk_rope_dim)
                per_layer += a.kv_lora_rank            # kv norm
                per_layer += a.kv_lora_rank * a.num_heads * (a.qk_nope_dim + a.v_head_dim)
                per_layer += a.num_heads * a.v_head_dim * d
            else:
                per_layer += d * a.num_heads * hd      # q
                per_layer += 2 * d * a.num_kv_heads * hd  # k,v
                per_layer += a.num_heads * hd * d      # o
            per_layer += d                             # attn norm
        n_mats = 3 if self.gated_mlp else 2
        if self.family == "moe":
            m = self.moe
            per_layer += d * m.num_experts             # router
            per_layer += m.num_experts * n_mats * d * self.d_ff
            per_layer += m.num_shared_experts * n_mats * d * self.d_ff
            per_layer += d                             # ffn norm
        elif self.d_ff > 0 and self.family != "hybrid":
            per_layer += n_mats * d * self.d_ff        # mlp
            per_layer += d                             # ffn norm
        if self.family == "hybrid":
            n += self.num_layers * per_layer
            # one shared attention + mlp block
            a = self.attention
            hd = self.head_dim
            shared = d * a.num_heads * hd + 2 * d * a.num_kv_heads * hd + a.num_heads * hd * d
            shared += (3 if self.gated_mlp else 2) * d * self.d_ff + 2 * d
            n += shared
        else:
            n += self.num_layers * per_layer
        if self.num_encoder_layers:
            a = self.attention
            hd = self.head_dim
            enc_layer = d * a.num_heads * hd * 2 + 2 * d * a.num_kv_heads * hd * 2  # self+cross? enc has self only
            enc_layer = (d * a.num_heads * hd + 2 * d * a.num_kv_heads * hd
                         + a.num_heads * hd * d
                         + (3 if self.gated_mlp else 2) * d * self.d_ff + 2 * d)
            n += self.num_encoder_layers * enc_layer
            # decoder cross-attention (added on top of self-attn counted above)
            cross = (d * a.num_heads * hd + 2 * d * a.num_kv_heads * hd
                     + a.num_heads * hd * d + d)
            n += self.num_layers * cross
        n += d                                         # final norm
        return n


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    """Trainer / FL-aggregation knobs (the paper's technique lives here)."""
    aggregation: str = "mean"       # mean | obcsaa | topk_aa
    optimizer: str = "sgd"          # sgd | momentum | adam  (paper: plain GD)
    learning_rate: float = 0.1
    # Per-worker error-feedback residual (Stich et al., §11/§17): the
    # residual accumulates what the 1-bit uplink dropped, so it only
    # means anything under the compressing aggregator.
    error_feedback: bool = False
    # OBCSAA knobs (paper notation)
    cs_chunk: int = 4096            # D_c  (chunked measurement, DESIGN.md §4)
    cs_measure: int = 1024          # S_c  (compressed rows per chunk)
    cs_topk: int = 409              # kappa_c per chunk (~10%)
    biht_iters: int = 5
    # 1-bit CS decoder (repro_torch.decode registry, DESIGN.md §9):
    # iht | niht | biht | iht_warm | iht_fused
    cs_decoder: str = "biht"
    # Decoder step size. biht uses tau/S (paper §V; 1.0 is the paper
    # setting). The fixed-step iht family needs tau below the restricted
    # operator norm — ~0.25 at the default decode budget kappa_bar = S_c/2
    # (see benchmarks/decoders_bench.py); niht adapts and ignores this.
    cs_tau: float = 1.0
    noise_var: float = 1e-4         # sigma^2 (mW)
    p_max: float = 10.0             # P^Max (mW)
    # §Perf knobs (beyond-paper; False/f32 = paper-faithful baseline)
    cs_shard_aligned: bool = False  # chunk along the model-sharded dim
    cs_packed: bool = False         # 32-signs-per-uint32 wire format (§13)
    wire_dtype: str = "float32"     # MAC symbol dtype (bf16 halves psum B/W)
    remat: bool = True
    # Remat granularity for the scanned layer stack (DESIGN.md §16):
    # None -> derive from the bool `remat` ("full" / "off"); otherwise one
    # of "off" | "full" | "dots" | "dots_no_batch".
    remat_policy: Optional[str] = None
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        # Eager geometry validation: a packed uplink rides 32 signs per
        # uint32 word, so S_c must pack evenly. Failing here (at config
        # construction) names the field; failing later surfaces as an
        # opaque reshape error deep in the Pallas kernels.
        if self.cs_packed and self.cs_measure % 32 != 0:
            raise ValueError(
                f"TrainConfig.cs_measure={self.cs_measure} does not satisfy "
                f"the packed-wire geometry: cs_packed=True needs "
                f"cs_measure % 32 == 0 (32 signs per uint32 word, "
                f"DESIGN.md §13). Pick a multiple of 32 or set "
                f"cs_packed=False.")
        valid_remat = (None, "off", "full", "dots", "dots_no_batch")
        if self.remat_policy not in valid_remat:
            raise ValueError(
                f"TrainConfig.remat_policy={self.remat_policy!r} not in "
                f"{valid_remat}")
        valid_opt = ("sgd", "momentum", "adam")
        if self.optimizer not in valid_opt:
            raise ValueError(
                f"TrainConfig.optimizer={self.optimizer!r} is not a "
                f"registered optimizer; choose one of "
                f"{' | '.join(valid_opt)} (repro_torch.optim.OPTIMIZERS)")
        if self.error_feedback and self.aggregation != "obcsaa":
            raise ValueError(
                f"TrainConfig.error_feedback=True needs "
                f"aggregation='obcsaa': the EF residual accumulates what "
                f"the 1-bit compressed uplink dropped (DESIGN.md §11/§17) "
                f"— under aggregation={self.aggregation!r} nothing is "
                f"dropped and the residual geometry is undefined. Set "
                f"aggregation='obcsaa' or error_feedback=False.")

    @property
    def remat_mode(self):
        """Effective remat knob for ``models.transformer.remat_wrap``."""
        if self.remat_policy is not None:
            return self.remat_policy
        return "full" if self.remat else "off"


def scaled(cfg: ModelConfig, **overrides) -> ModelConfig:
    return dataclasses.replace(cfg, **overrides)


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
