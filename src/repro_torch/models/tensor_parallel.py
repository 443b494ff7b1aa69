"""Tensor parallelism of the serving path: one rank's share of the weights
over a mesh's model group, and the collectives that stand in for the
reference's GSPMD layout.

Under ``torchrun`` the R = W·M ranks of ``launch.mesh.world_mesh(M)``
serve one model. The model group (the M ranks of one worker row) splits
every large weight; the data group (the W ranks of one model column)
splits the cache, each leaf as ``launch.steps.cache_shardings`` lays it
out (``transformer.init_lm_cache``). The reference gets this from GSPMD
and the model code's hints (heads, the MLP's hidden dim, the vocabulary
of the logits, the SSM's projection); here the split and its collectives
are written out:

- GQA: query and KV heads split (``wq``/``wk``/``wv``/``wo``), one sum
  after ``wo``.
- MLA: heads split (``w_uq`` or ``wq``, ``w_uk``, ``w_uv``, ``wo``);
  ``w_dq``, ``w_dkv`` and ``w_kr`` split by their input rows, their three
  partial products summed in one all-reduce; the cached latent ``ckv``
  split by its columns, so the absorbed scores and the latent output are
  partial over the group (``attention.mla_decode``).
- MLP, routed and shared experts: the hidden columns of ``w1``/``w3``
  and rows of ``w2``, one sum after them. The MoE's router is gathered
  whole, so routes and capacity slots are those of one process.
- Mamba2: its heads and their groups of B/C split. ``in_proj``'s and the
  conv's columns are this rank's own channels, [z | x | B | C | dt] taken
  by head and group: as many as the contiguous block ``param_shardings``
  names, not the same ones. The gated norm's sum of squares is summed
  over the group; one sum after ``out_proj``.
- The vocabulary: the embedding's rows (a masked lookup, then a sum) and
  the logits' columns; ``greedy`` is ``collectives.argmax_split``. The
  encoder-decoder's position table is split by rows the same way.

``param_shardings`` splits each leaf's largest divisible dim; where that
is not the dim above, the share here is still 1/M of the leaf, so the
dry run's product rule gives a rank's bytes. Every other leaf it splits
is held as it splits it and gathered whole where it is used (``whole``):
the norms' scales and the other small leaves once a call, in one
all-gather; the router, the image position marker, and every weight of
a module whose heads, hidden dim or vocabulary do not divide by M (its
compute then runs whole on every rank of the group) a layer at a time.

A rank's share of the seed-0 init is cut as each weight is drawn
(``init_params``), so it never holds the whole model; for ranks that
share one card, ``draw_staged`` keeps the shares on the host until the
last draw and ``unstage`` moves them to the card.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives as coll
from repro_torch.dist.sharding import STACKED_KEYS, _best_model_dim
from repro_torch.models.layers import init_cut
from repro_torch.models.ssm import ssm_dims

BLOCK, OWN, GATHER = "block", "own", "gather"


@dataclass(frozen=True)
class Rule:
    """How a rank holds one leaf: its ``kind``'s share along ``dim``
    (negative, so a layer's slice of a stacked leaf reads it too) of the
    whole ``shape``; ``stacked`` leaves carry the layer axis first."""
    kind: str
    dim: int
    shape: Tuple[int, ...]
    stacked: bool


@dataclass(frozen=True)
class Flags:
    """Which modules split over M ranks: their heads (and the MLA's
    latent and input rows), hidden dims, SSM heads and groups, and the
    vocabulary divide by M."""
    vocab: bool
    attn: bool
    mlp: bool
    ssm: bool


def flags_of(cfg: ModelConfig, M: int) -> Flags:
    def ok(*ns):
        return all(int(n) % M == 0 for n in ns)

    a, s = cfg.attention, cfg.ssm
    attn = False
    if a is not None:
        attn = (ok(a.num_heads, a.kv_lora_rank, cfg.d_model) if a.use_mla
                else ok(a.num_heads, a.num_kv_heads))
    ssm = False
    if s is not None:
        ssm = ok(ssm_dims(cfg.d_model, s)[1], s.n_groups)
    return Flags(vocab=ok(cfg.vocab_size), attn=attn,
                 mlp=bool(cfg.d_ff) and ok(cfg.d_ff), ssm=ssm)


_SSM = {"in_proj": (OWN, -1), "conv_w": (OWN, -1), "conv_b": (OWN, -1),
        "A_log": (BLOCK, -1), "D": (BLOCK, -1), "dt_bias": (BLOCK, -1),
        "gate_norm": (BLOCK, -1), "out_proj": (BLOCK, -2)}
_GQA = {"wq": (BLOCK, -2), "wk": (BLOCK, -2), "wv": (BLOCK, -2),
        "wo": (BLOCK, -3)}
_MLA = {"w_dq": (BLOCK, -2), "w_uq": (BLOCK, -2), "wq": (BLOCK, -2),
        "w_dkv": (BLOCK, -2), "w_kr": (BLOCK, -2), "w_uk": (BLOCK, -2),
        "w_uv": (BLOCK, -2), "wo": (BLOCK, -3)}
_MLP = {"w1": (BLOCK, -1), "w3": (BLOCK, -1), "w2": (BLOCK, -2),
        "ew1": (BLOCK, -1), "ew3": (BLOCK, -1), "ew2": (BLOCK, -2)}


def _rule(keys, shape, cfg: ModelConfig, fl: Flags, M: int
          ) -> Optional[Rule]:
    name = keys[-1]
    parents = {k for k in keys[:-1] if isinstance(k, str)}
    stacked = bool(parents & set(STACKED_KEYS))
    want = None
    if name == "embedding" and fl.vocab:
        want = (BLOCK, -2)
    elif name == "lm_head" and fl.vocab:
        want = (BLOCK, -1)
    elif name == "pos_embedding" and shape[0] % M == 0:
        want = (BLOCK, -2)
    elif "ssm" in parents and fl.ssm:
        want = _SSM.get(name)
    elif parents & {"attn", "cross"} and fl.attn:
        mla = cfg.attention.use_mla and "cross" not in parents
        want = (_MLA if mla else _GQA).get(name)
    elif parents & {"mlp", "moe"} and fl.mlp:
        want = _MLP.get(name)
    if want is None:
        d = _best_model_dim(tuple(shape), M, skip_leading=stacked)
        if d is None:
            return None
        want = (GATHER, d - len(shape))
    return Rule(want[0], want[1], tuple(shape), stacked)


@functools.lru_cache(maxsize=32)
def rules_of(cfg: ModelConfig, M: int) -> Dict[tuple, Rule]:
    """{leaf key path: Rule} of ``cfg``'s parameters over M ranks; a leaf
    absent is held whole."""
    from repro_torch.models.registry import build_model
    fl = flags_of(cfg, M)
    out = {}
    for keys, leaf in tree.flatten_with_keys(
            build_model(cfg).init(0, device="meta")):
        r = _rule(keys, tuple(leaf.shape), cfg, fl, M)
        if r is not None:
            out[tuple(keys)] = r
    return out


def _own_index(cfg: ModelConfig, M: int, m: int, name: str, device
               ) -> torch.Tensor:
    """Rank m's own channels of a Mamba2 ``in_proj`` ([z | x | B | C |
    dt]) or conv (``conv_w``/``conv_b``: [x | B | C]) column axis."""
    s = cfg.ssm
    di, h, _ = ssm_dims(cfg.d_model, s)
    gn = s.n_groups * s.d_state
    sizes = ([di, di, gn, gn, h] if name == "in_proj" else [di, gn, gn])
    parts, base = [], 0
    for n in sizes:
        parts.append(torch.arange(base + m * n // M, base + (m + 1) * n // M,
                                  device=device))
        base += n
    return torch.cat(parts)


def share_of(leaf: torch.Tensor, rule: Optional[Rule], cfg: ModelConfig,
             M: int, m: int, name: str = "") -> torch.Tensor:
    """Rank m's share of a whole leaf under ``rule``: a new tensor (the
    whole can be freed), the leaf itself when it is held whole."""
    if rule is None:
        return leaf
    if rule.kind == OWN:
        return leaf.index_select(rule.dim % leaf.dim(), _own_index(
            cfg, M, m, name, leaf.device))
    n = leaf.shape[rule.dim] // M
    return leaf.narrow(rule.dim, m * n, n).clone(
        memory_format=torch.contiguous_format)


def shard_params(params, cfg: ModelConfig, M: int, m: int):
    """Model shard m's share of the whole parameters (of ``cfg``, as the
    port's init or ``convert.lm_params_from_reference`` gives them) over
    M ranks: every leaf ``rules_of`` splits cut to 1/M, the others
    whole."""
    if M == 1:
        return params
    rules = rules_of(cfg, M)
    flat, treedef = tree.flatten(params)
    keys = [k for k, _ in tree.flatten_with_keys(params)]
    return tree.unflatten(treedef, [
        share_of(leaf, rules.get(tuple(k)), cfg, M, m, k[-1])
        for k, leaf in zip(keys, flat)])


class Split:
    """One rank's place in tensor-parallel serving: the model group
    (``model``, M ranks, this one m), the data group (``data``, W ranks,
    this one d), ``flags``, and the leaves' ``rules``."""

    def __init__(self, cfg: ModelConfig, mesh):
        self.cfg = cfg
        self.M = mesh.shape["model"]
        self.W = mesh.shape.get("data", 1)
        self.model, self.data = mesh.model_group, mesh.group
        self.m, self.d = coll.axis_index(self.model), coll.axis_index(
            self.data)
        self.flags = flags_of(cfg, self.M)
        self.rules = rules_of(cfg, self.M)

    def group(self, what: str):
        """The model group where ``what`` ("attn", "mlp", "ssm", "vocab")
        is split, else None: its weights are gathered whole."""
        return self.model if getattr(self.flags, what) else None

    def whole(self, local, prefix: tuple = (), small_only: bool = False):
        """``local`` (the subtree at ``prefix``) with each leaf whose rule
        is GATHER and that is not whole yet gathered whole over the model
        group, all in one all-gather; with ``small_only`` only the leaves
        outside the layer stacks and the stacked ones of one dim a layer
        (the norms' scales). A new tree; the other leaves as they were."""
        flat, treedef = tree.flatten(local)
        keys = [prefix + tuple(k) for k, _ in tree.flatten_with_keys(local)]
        todo = []
        for i, (k, leaf) in enumerate(zip(keys, flat)):
            r = self.rules.get(k)
            if r is None or r.kind != GATHER or \
                    tuple(leaf.shape) == r.shape[-leaf.dim():]:
                continue
            if small_only and r.stacked and len(r.shape) > 2:
                continue
            todo.append(i)
        if not todo:
            return local
        got = gather_blocks([flat[i] for i in todo],
                            [self.rules[keys[i]].dim for i in todo],
                            self.model)
        for i, g in zip(todo, got):
            flat[i] = g
        return tree.unflatten(treedef, flat)


def gather_blocks(locals_, dims, group):
    """The whole tensors whose equal blocks along ``dims`` the group's
    ranks hold, in rank order: one all-gather of every block flattened
    into one buffer (one dtype)."""
    M = coll.axis_size(group)
    buf = torch.cat([t.reshape(-1) for t in locals_])
    every = coll.all_gather(buf, group)                 # (M, n)
    out, off = [], 0
    for t, dim in zip(locals_, dims):
        k = t.numel()
        parts = every[:, off:off + k].reshape((M,) + tuple(t.shape))
        out.append(torch.cat(parts.unbind(0), dim=dim))
        off += k
    return out


def split_of(cfg: ModelConfig, mesh) -> Optional[Split]:
    """The ``Split`` of ``mesh`` (a ``launch.mesh.world_mesh`` with its
    groups); None without a mesh or with a model axis of 1."""
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    return Split(cfg, mesh)


#: where a staged init keeps the shares until the last draw: the host
STAGE = torch.device("cpu")
#: the bytes of a leaf's whole that ``stage_share`` cuts at once
STAGE_BLOCK_BYTES = 1 << 28


def stage_share(leaf: torch.Tensor, rule: Optional[Rule], cfg: ModelConfig,
                M: int, m: int, name: str) -> torch.Tensor:
    """``share_of`` made on ``STAGE`` straight from the whole ``leaf``: a
    block of its leading dim at a time (``STAGE_BLOCK_BYTES`` of the
    whole; a layer of a stacked expert leaf), so that ``leaf``'s device
    holds no more than one block's share beside the whole; a share that
    is a contiguous slice (the leading dim's own block) is copied as it
    is. The host memory is pageable: PyTorch's page-locked allocator
    rounds a block up to a power of two (a 9.28 GiB share would take 16
    GiB)."""
    def empty(shape):
        return torch.empty(shape, dtype=leaf.dtype, device=STAGE)

    if rule is None:
        return empty(leaf.shape).copy_(leaf)
    d = rule.dim % leaf.dim()
    if d == 0:
        part = (share_of(leaf, rule, cfg, M, m, name) if rule.kind == OWN
                else leaf.narrow(0, m * (leaf.shape[0] // M),
                                 leaf.shape[0] // M))
        return empty(part.shape).copy_(part)
    n0 = leaf.shape[0]
    step = max(1, STAGE_BLOCK_BYTES // max(1, leaf[0].numel()
                                           * leaf.element_size()))
    out = None
    for a in range(0, n0, step):
        part = share_of(leaf[a:a + step], rule, cfg, M, m, name)
        if out is None:
            out = empty((n0,) + tuple(part.shape[1:]))
        out[a:a + step].copy_(part)
    return out


def share_bytes(cfg: ModelConfig, M: int) -> int:
    """The bytes of one rank's share of ``cfg``'s parameters over M
    ranks: 1/M of every leaf ``rules_of`` splits, the others whole."""
    from repro_torch.models.registry import build_model
    rules = rules_of(cfg, M)
    return sum(leaf.numel() * leaf.element_size()
               // (M if tuple(k) in rules else 1)
               for k, leaf in tree.flatten_with_keys(
                   build_model(cfg).init(0, device="meta")))


def host_available() -> int:
    """The host's ``MemAvailable`` (``/proc/meminfo``), in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable line")


def check_host_room(need: int, ranks: int) -> None:
    """Fail unless the host has ``need`` bytes free for each of the
    ``ranks`` ranks that stage their shares on it at once."""
    have = host_available()
    if have < need * ranks:
        raise RuntimeError(
            f"a staged init needs {need / 2**30:.2f} GiB of host memory a "
            f"rank for {ranks} rank(s) on this host "
            f"({need * ranks / 2**30:.2f} GiB), and MemAvailable is "
            f"{have / 2**30:.2f} GiB: run fewer ranks a host, or an init "
            "that is not staged where the card holds it")


def draw_staged(model, seed: int, M: int, m: int, device, ranks: int):
    """The first half of a staged init: model shard m's share (of M) of
    ``model.init(seed)``, every share made on the host (``stage_share``)
    as its weight is drawn on ``device``; returns the shares there. The
    generator runs on ``device`` as for the whole init, so ``unstage``
    of the result is ``init_params``' share bit for bit, while
    ``device`` holds only the weight being drawn and a block of its
    share: M ranks that share one card draw at once in M whole weights'
    room (deepseek-v2-lite-16b's stacked experts: 18.56 GiB each in
    f32). ``ranks``: the ranks that stage on this host at once; the init
    fails before it draws when ``MemAvailable`` cannot hold all their
    shares."""
    cfg = model.cfg
    rules = rules_of(cfg, M)
    check_host_room(share_bytes(cfg, M), ranks)
    return init_cut(model, seed, lambda k, w: stage_share(
        w, rules.get(k), cfg, M, m, k[-1]), device=device)


def unstage(staged, device):
    """The second half of a staged init: the device's cached blocks freed
    (the last whole weight's), then every share moved to ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return tree.tree_map(lambda x: x.to(dev), staged)


def init_params(model, seed: int, mesh, device=None):
    """This rank's share of ``model.init(seed)``, exactly the slice of the
    whole: each weight cut to this rank's share as the init draws it
    (``layers.init_cut``). A rank holds its shares and at most one whole
    weight on ``device``; where the ranks of a model group share one card
    and their whole weights do not fit beside the shares, stage the init
    on the host instead (``draw_staged``, then ``unstage``). Without a
    model axis: the whole init."""
    sp = split_of(model.cfg, mesh)
    if sp is None:
        return model.init(seed, device=device)
    cfg = model.cfg
    return init_cut(model, seed, lambda k, w: share_of(
        w, sp.rules.get(k), cfg, sp.M, sp.m, k[-1]), device=device)


def greedy(logits: torch.Tensor, cfg: ModelConfig, mesh) -> torch.Tensor:
    """The argmax of ``logits`` (..., V or this rank's V/M columns) over
    the whole vocabulary, on every rank."""
    sp = split_of(cfg, mesh)
    return coll.argmax_split(logits, None if sp is None
                             else sp.group("vocab"))


def gather_logits(logits: torch.Tensor, cfg: ModelConfig, mesh
                  ) -> torch.Tensor:
    """The whole vocabulary's logits from each rank's columns (as they
    are where the vocabulary is not split)."""
    sp = split_of(cfg, mesh)
    group = None if sp is None else sp.group("vocab")
    if group is None:
        return logits
    return coll.all_gather(logits.contiguous(), group, axis=-1, tiled=True)
