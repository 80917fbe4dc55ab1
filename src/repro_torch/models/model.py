"""Model assembly: the decoder-only LM (dense, MoE, MLA, and the vision-stub
VLM decoder), xLSTM, the Zamba2-style hybrid and the encoder-decoder
(audio-stub frames), cache-aware, declared via P-descriptors, in torch.

Port of `repro.models.model`'s `TransformerLM`, `XLSTMLM`, `HybridLM` and
`EncDecLM`. Layers are stacked on a leading axis as in the reference and
run as a Python loop over that axis; under autograd with `cfg.remat` (the
default) and no cache, each unit the reference scans (a transformer layer,
an xLSTM group, a Mamba layer, an encoder or decoder layer) runs under
`torch.utils.checkpoint`, as the reference's `jax.checkpoint` of its
scanned body, so a training step keeps one activation a unit. The leading
dense layers of an MoE config (`dense_blocks`) and the hybrid's shared
attention run outside it, as in the reference.

Public API (built by `build_model(cfg, device=...)`):
  model.desc()                          -> param descriptor tree
  model.forward(params, batch, cache)   -> (logits, new_cache)
  model.loss(params, batch)             -> (loss, metrics)
  model.cache_desc(batch, max_len)      -> cache TensorSpec tree
  model.init_cache(batch, max_len)      -> initialized cache
  model.decode_step(params, tok, cache) -> (logits, new_cache)

The model's `device` (default the GPU, see `repro_torch.device`) is where
its caches live; params and batches are expected there too. A cache's
tensors (K/V rows, recurrent states) are updated in place by `forward`:
the returned cache holds the same tensors with the new values written,
and a new position clock.

Under a mesh (`runtime.sharding.activate`) every family takes params,
tokens, labels, patch embeddings, frames and caches as DTensors:
`init_cache` lays the cache out by `runtime.sharding.cache_sharding`
(recurrent states and the encoder memory included), and `loss` is taken on
the logits' batch and vocab shards (`_sharded_loss`).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .. import device as _device
from . import blocks, nn, ssm, xlstm
from .config import ModelConfig
from .nn import P, TensorSpec, dense, rms_norm, shard


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _zeros_cache(desc_tree, device: torch.device):
    return nn.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device), desc_tree)


def _stack_specs(tree: dict, *lead: int) -> dict:
    """The specs of `tree` (nested dicts) stacked on the leading axes
    `lead`, without a per-layer 'len'."""
    return {k: _stack_specs(s, *lead) if isinstance(s, dict) else TensorSpec(lead + s.shape, s.dtype)
            for k, s in tree.items() if k != "len"}


def _sharded_loss(logits, labels):
    """`BaseLM.loss` on DTensor logits (B, L, V), split by batch and vocab,
    and labels laid out by `launch.dryrun.batch_shardings`, taken on each
    rank's shards: the row maximum as an all-reduce max (held constant:
    it cancels), the log of the summed exponentials and the label's logit
    (a masked pick in the rank's vocab rows) as pending sums over the
    vocab's mesh dims, and the masked sums over the batch's. Loss and
    tokens come out replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..runtime import sharding

    mesh = logits.device_mesh
    if not all(p in (Shard(0), Shard(2)) or isinstance(p, Replicate) for p in logits.placements):
        raise ValueError(f"the loss takes logits split by batch and vocab, got {logits.placements}")
    labels = sharding.lay_out(labels, sharding.NamedSharding(mesh, tuple(
        Shard(0) if p == Shard(0) else Replicate() for p in logits.placements)))
    vocab = tuple(Partial() if p == Shard(2) else Replicate() for p in logits.placements)
    rows = tuple(Partial() if p == Shard(0) else Replicate() for p in logits.placements)
    # shape (B, L), laid out by the batch split and pending over the vocab's
    pend = tuple(Shard(0) if p == Shard(0) else q for p, q in zip(logits.placements, vocab))
    shape = tuple(logits.shape[:2])

    def summed(local, placements, shape):
        lay = sharding.NamedSharding(mesh, placements)
        return nn.reduce_partial(sharding.from_local(local, lay, shape))

    local = logits.to_local()
    start, _ = sharding.local_box(sharding.NamedSharding(mesh, tuple(logits.placements)),
                                  tuple(logits.shape))
    top = sharding.from_local(torch.amax(local.detach(), dim=-1),
                              sharding.NamedSharding(mesh, tuple(
                                  Partial("max") if isinstance(q, Partial) else q for q in pend)),
                              shape)
    top = nn.reduce_partial(top).to_local()
    sumexp = summed(torch.sum(torch.exp(local - top[..., None]), dim=-1), pend, shape).to_local()
    lab = labels.to_local()
    ids = torch.clamp(lab, min=0).long() - start[2]
    hit = (ids >= 0) & (ids < local.shape[-1])
    picked = torch.gather(local, -1, ids.clamp(0, local.shape[-1] - 1)[..., None])[..., 0]
    picked = summed(torch.where(hit, picked, torch.zeros((), dtype=local.dtype,
                                                         device=local.device)), pend, shape)
    nll = top + torch.log(sumexp) - picked.to_local()
    mask = (lab >= 0).to(torch.float32)
    num = summed(torch.sum(nll * mask), rows, ())
    den = summed(torch.sum(mask), rows, ())
    loss = num / torch.clamp(den, min=1.0)
    return loss, {"loss": loss, "tokens": den}


class BaseLM:
    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = _device.resolve(device)

    def _check_mesh(self) -> None:
        if nn.shard_fn() is None:
            raise RuntimeError("sharded params run under runtime.sharding.activate(mesh, rules)")

    # --- embedding / head -------------------------------------------------
    def _embed_desc(self) -> dict:
        cfg = self.cfg
        out = {
            "embed": P((cfg.vocab, cfg.d_model), ("vocab", "embed"), "embed"),
            "final_norm": P((cfg.d_model,), ("norm",), "ones"),
        }
        if not cfg.tie_embeddings:
            out["lm_head"] = P((cfg.d_model, cfg.vocab), ("embed", "vocab"))
        if cfg.frontend == "vision":
            out["patch_proj"] = P((cfg.d_model, cfg.d_model), ("embed", "embed"))
        if cfg.frontend == "audio":
            out["frame_proj"] = P((cfg.d_model, cfg.d_model), ("embed", "embed"))
        return out

    def _embed(self, params, batch) -> torch.Tensor:
        cfg = self.cfg
        if nn.is_sharded(params["embed"]):
            self._check_mesh()
        # a vocab-split table gives each rank its rows' lookups and zeros
        # elsewhere: a pending sum, added before the cast
        x = nn.reduce_partial(nn.embed(params["embed"], batch["tokens"])).to(_dt(cfg))
        if cfg.frontend == "vision" and "patch_embeds" in batch:
            pe = dense(batch["patch_embeds"].to(_dt(cfg)), params["patch_proj"])
            x = nn.cat([pe, x], 1)
        return shard(x, "batch", None, None)

    def _logits(self, params, x) -> torch.Tensor:
        cfg = self.cfg
        xn = rms_norm(x, params["final_norm"], cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = dense(xn, head)
        return shard(logits.to(torch.float32), "batch", None, "vocab")

    # --- losses ------------------------------------------------------------
    def loss(self, params, batch):
        logits, _ = self.forward(params, batch, cache=None)
        labels = batch["labels"]
        if self.cfg.frontend == "vision" and "patch_embeds" in batch:
            # logits cover [patches, tokens]; labels only the token part
            n = labels.shape[1]
            logits = nn.on_shards(lambda t: t[:, -n:], logits,
                                  (logits.shape[0], n, logits.shape[2]))
        if nn.is_sharded(logits):
            return _sharded_loss(logits, labels)
        mask = (labels >= 0).to(torch.float32)
        lab = torch.clamp(labels, min=0).long()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
        loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
        return loss, {"loss": loss, "tokens": torch.sum(mask)}

    # --- cache -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, *, seq_shard: bool = False):
        """Zeros: plain tensors on the model's device, or under a mesh
        DTensors laid out by `cache_sharding` (batch over the data dims,
        the first head-sized dim after it over 'model'; with `seq_shard`,
        where no head dim can take 'model', the sequence over it)."""
        layout = nn.shard_fn()
        if layout is None:
            return _zeros_cache(self.cache_desc(batch, max_len), self.device)
        self._check_mesh()
        from ..runtime import sharding

        desc = self.cache_desc(batch, max_len)
        cfg = self.cfg
        shardings = sharding.cache_sharding(desc, layout.mesh, batch,
                                            {cfg.n_kv_heads, cfg.n_heads}, seq_shard=seq_shard)
        return nn.tree_map(lambda s, sh: sharding.zeros(s.shape, s.dtype, sh), desc, shardings)

    def decode_step(self, params, tokens, cache):
        return self.forward(params, {"tokens": tokens}, cache=cache)


# ---------------------------------------------------------------------------
# decoder-only transformer (dense / moe / mla / vlm)
# ---------------------------------------------------------------------------


class TransformerLM(BaseLM):
    """Dense or MoE decoder-only LM; attention is GQA or MLA per config.

    An MoE config with `moe.n_dense_layers` leading dense layers keeps them
    in a second stack, `dense_blocks`, run before `blocks`; their caches
    (and paged arenas) are a second stack too."""

    def _attn_desc(self):
        return blocks.desc_mla(self.cfg) if self.cfg.mla else blocks.desc_attn(self.cfg)

    def _mlp_desc(self):
        return blocks.desc_moe(self.cfg) if self.cfg.moe else blocks.desc_mlp(self.cfg)

    def _n_dense(self) -> int:
        return self.cfg.moe.n_dense_layers if self.cfg.moe else 0

    def desc(self):
        cfg = self.cfg
        nd = self._n_dense()
        out = self._embed_desc()
        if nd:
            dense_layer = {"attn": self._attn_desc(), "mlp": blocks.desc_mlp(cfg)}
            out["dense_blocks"] = nn.stack_layers([dense_layer] * nd)
        layer = {"attn": self._attn_desc(), "mlp": self._mlp_desc()}
        out["blocks"] = nn.stack_layers([layer] * (cfg.n_layers - nd))
        return out

    def _block(self, p, x, positions, cache, window=None):
        cfg = self.cfg
        if cfg.mla:
            a, new_c = blocks.apply_mla(p["attn"], x, positions, cfg, cache=cache)
        else:
            a, new_c = blocks.apply_attn(p["attn"], x, positions, cfg, cache=cache, window=window)
        x = x + a
        if cfg.moe and "router" in p["mlp"]:
            x = x + blocks.apply_moe(p["mlp"], x, cfg)
        else:
            x = x + blocks.apply_mlp(p["mlp"], x, cfg)
        return x, new_c

    def _remat_block(self, p, x, positions, window):
        return self._block(p, x, positions, None, window=window)[0]

    def forward(self, params, batch, cache=None):
        cfg = self.cfg
        x = self._embed(params, batch)
        b, l, _ = x.shape
        steps = torch.arange(l, device=x.device)
        clock = cache["pos"] if cache is not None else 0
        pos0 = nn.local_value(clock)  # a replicated clock's value on every rank
        # paged serving cache (DESIGN.md §9): per-slot clocks (B,) + page
        # table, threaded into every layer's cache view
        paged = cache is not None and "page_table" in cache
        positions = pos0[:, None] + steps[None, :] if paged else pos0 + steps[None, :]

        extra = {"ptab": cache["page_table"]} if paged else {}

        def run_layer(stack, i, p, x, window=None):
            def block(c):
                cl = None if c is None else dict(c, len=pos0, **extra)
                return self._block(p, x, positions, cl, window=window)[0]

            return _with_layer_cache(block, None if cache is None else cache[stack], i)

        nd = self._n_dense()
        # the leading dense layers run first and are not checkpointed, as
        # in the reference
        for i, p in enumerate(nn.unstack(params["dense_blocks"], nd) if nd else []):
            x = run_layer("dense_blocks", i, p, x)
        # training: each stacked layer's activations are recomputed in the
        # backward (the reference's jax.checkpoint of the scanned layer)
        remat = cache is None and cfg.remat and torch.is_grad_enabled()
        for i, p in enumerate(nn.unstack(params["blocks"], cfg.n_layers - nd)):
            if remat:
                x = checkpoint(self._remat_block, p, x, positions, cfg.attn_window,
                               use_reentrant=False)
                continue
            x = run_layer("blocks", i, p, x, window=cfg.attn_window)
        new_cache = None
        if cache is not None:
            # the layers wrote their rows into the cache stacks in place
            new_cache = {"pos": clock + l, "blocks": cache["blocks"]}
            if nd:
                new_cache["dense_blocks"] = cache["dense_blocks"]
            if paged:
                new_cache["page_table"] = cache["page_table"]
        return self._logits(params, x), new_cache

    def _stacks(self, one: dict) -> dict:
        nd = self._n_dense()
        out = {"blocks": _stack_specs(one, self.cfg.n_layers - nd)}
        if nd:
            out["dense_blocks"] = _stack_specs(one, nd)
        return out

    def cache_desc(self, batch: int, max_len: int):
        cfg = self.cfg
        one = (blocks.mla_cache_desc(cfg, batch, max_len) if cfg.mla
               else blocks.attn_cache_desc(cfg, batch, max_len))
        return {"pos": TensorSpec((), torch.int32), **self._stacks(one)}

    # --- paged serving cache (DESIGN.md §9) --------------------------------
    def paged_cache_desc(self, slots: int, pages: int, page_tokens: int, max_pages: int):
        """Cache specs for the paged serving tier: per-slot position clocks +
        a (slots, max_pages) page table over a shared page arena of `pages`
        allocatable pages per layer (page 0 is reserved scratch, so arenas
        are sized pages+1)."""
        cfg = self.cfg
        if cfg.mla:
            raise NotImplementedError("paged KV cache does not support MLA")
        one = blocks.paged_attn_cache_desc(cfg, pages, page_tokens)
        return {
            "pos": TensorSpec((slots,), torch.int32),
            "page_table": TensorSpec((slots, max_pages), torch.int32),
            **self._stacks(one),
        }

    def init_paged_cache(self, slots: int, pages: int, page_tokens: int, max_pages: int):
        return _zeros_cache(self.paged_cache_desc(slots, pages, page_tokens, max_pages),
                            self.device)


# ---------------------------------------------------------------------------
# xLSTM (groups of m mLSTM + s sLSTM)
# ---------------------------------------------------------------------------


class XLSTMLM(BaseLM):
    """Groups of `m_per_group` mLSTM blocks then `s_per_group` sLSTM
    blocks, stacked over groups (`groups/{m,s}`, each stacked again over
    its blocks)."""

    def _gcount(self) -> int:
        xc = self.cfg.xlstm
        per = xc.m_per_group + xc.s_per_group
        if self.cfg.n_layers % per:
            raise ValueError(f"{self.cfg.name}: {self.cfg.n_layers} layers are not whole "
                             f"groups of {per}")
        return self.cfg.n_layers // per

    def desc(self):
        cfg = self.cfg
        xc = cfg.xlstm
        group = {
            "m": nn.stack_layers([xlstm.desc_mlstm(cfg)] * xc.m_per_group),
            "s": nn.stack_layers([xlstm.desc_slstm(cfg)] * xc.s_per_group),
        }
        out = self._embed_desc()
        out["groups"] = nn.stack_layers([group] * self._gcount())
        return out

    def _group(self, gp, x, gc=None):
        cfg = self.cfg
        xc = cfg.xlstm
        for kind, n, apply in (("m", xc.m_per_group, xlstm.apply_mlstm),
                               ("s", xc.s_per_group, xlstm.apply_slstm)):
            for i, p in enumerate(nn.unstack(gp[kind], n)):
                y, _ = _with_layer_cache(lambda c: apply(p, x, cfg, cache=c),
                                         None if gc is None else gc[kind], i)
                x = x + y
        return x

    def forward(self, params, batch, cache=None):
        cfg = self.cfg
        x = self._embed(params, batch)
        # training: each group's activations are recomputed in the backward
        # (the reference's jax.checkpoint of the scanned group)
        remat = cache is None and cfg.remat and torch.is_grad_enabled()
        for i, gp in enumerate(nn.unstack(params["groups"], self._gcount())):
            if remat:
                x = checkpoint(self._group, gp, x, use_reentrant=False)
            else:
                x = _with_layer_cache(lambda c: self._group(gp, x, c),
                                      None if cache is None else cache["groups"], i)
        new_cache = None
        if cache is not None:
            # the blocks wrote their states into the cache stacks in place
            new_cache = {"pos": cache["pos"] + x.shape[1], "groups": cache["groups"]}
        return self._logits(params, x), new_cache

    def init_cache(self, batch: int, max_len: int, *, seq_shard: bool = False):
        cache = super().init_cache(batch, max_len, seq_shard=seq_shard)
        # the mLSTM stabilizer starts at -1e30, as the chunked path's (each
        # rank fills its shard)
        m = cache["groups"]["m"]["m"]
        (m.to_local() if nn.is_sharded(m) else m).fill_(xlstm.M_INIT)
        return cache

    def cache_desc(self, batch: int, max_len: int):
        cfg = self.cfg
        xc = cfg.xlstm
        group = {
            "m": _stack_specs(xlstm.mlstm_cache_desc(cfg, batch), xc.m_per_group),
            "s": _stack_specs(xlstm.slstm_cache_desc(cfg, batch), xc.s_per_group),
        }
        return {"pos": TensorSpec((), torch.int32), "groups": _stack_specs(group, self._gcount())}


# ---------------------------------------------------------------------------
# Zamba2-style hybrid: Mamba2 backbone + shared attention block
# ---------------------------------------------------------------------------


class HybridLM(BaseLM):
    """`every` Mamba2 layers followed by one *shared* GQA attention block
    (weights reused at every application, a cache per application), its
    input fused with the original embedding (concat + projection),
    zamba-style. The Mamba layers left over after the last group form a
    tail (`mamba_tail`)."""

    def _layout(self) -> tuple[int, int, int]:
        cfg = self.cfg
        k = cfg.hybrid.every
        n_groups = cfg.n_layers // k
        return n_groups, k, cfg.n_layers - n_groups * k

    def desc(self):
        cfg = self.cfg
        n_groups, k, tail = self._layout()
        mamba = ssm.desc_mamba(cfg)
        out = self._embed_desc()
        out["mamba_groups"] = nn.stack_layers([nn.stack_layers([mamba] * k)] * n_groups)
        if tail:
            out["mamba_tail"] = nn.stack_layers([mamba] * tail)
        out["shared_attn"] = blocks.desc_attn(cfg)
        out["shared_mlp"] = blocks.desc_mlp(cfg)
        out["fuse"] = P((2 * cfg.d_model, cfg.d_model), ("embed", "embed"))
        return out

    def _mamba(self, p, x, cache=None):
        return x + ssm.apply_mamba(p, x, self.cfg, cache=cache)[0]

    def _mamba_stack(self, stacked, n: int, x, caches):
        # training: each Mamba layer's activations are recomputed in the
        # backward (the reference's jax.checkpoint of the scanned layer)
        remat = caches is None and self.cfg.remat and torch.is_grad_enabled()
        for i, p in enumerate(nn.unstack(stacked, n)):
            if remat:
                x = checkpoint(self._mamba, p, x, use_reentrant=False)
            else:
                x = _with_layer_cache(lambda c: self._mamba(p, x, c), caches, i)
        return x

    def forward(self, params, batch, cache=None):
        cfg = self.cfg
        n_groups, k, tail = self._layout()
        x = self._embed(params, batch)
        emb0 = x
        l = x.shape[1]
        clock = cache["pos"] if cache is not None else 0
        pos0 = nn.local_value(clock)  # a replicated clock's value on every rank
        positions = pos0 + torch.arange(l, device=x.device)[None, :]
        for gi, gp in enumerate(nn.unstack(params["mamba_groups"], n_groups)):
            x = _with_layer_cache(lambda c: self._mamba_stack(gp, k, x, c),
                                  None if cache is None else cache["mamba_groups"], gi)
            # shared attention block on [x ; emb0]
            fused = dense(nn.cat([x, emb0], -1), params["fuse"])
            a, _ = _with_layer_cache(
                lambda c: blocks.apply_attn(params["shared_attn"], fused, positions, cfg,
                                            cache=None if c is None else dict(c, len=pos0),
                                            window=cfg.attn_window),
                None if cache is None else cache["attn"], gi)
            x = x + a
            x = x + blocks.apply_mlp(params["shared_mlp"], x, cfg)
        if tail:
            x = self._mamba_stack(params["mamba_tail"], tail, x,
                                  None if cache is None else cache["mamba_tail"])
        # the blocks wrote their states and K/V rows into the cache in place
        new_cache = None if cache is None else dict(cache, pos=clock + l)
        return self._logits(params, x), new_cache

    def cache_desc(self, batch: int, max_len: int):
        cfg = self.cfg
        n_groups, k, tail = self._layout()
        mc = ssm.mamba_cache_desc(cfg, batch)
        out = {
            "pos": TensorSpec((), torch.int32),
            "mamba_groups": _stack_specs(mc, n_groups, k),
            "attn": _stack_specs(blocks.attn_cache_desc(cfg, batch, max_len), n_groups),
        }
        if tail:
            out["mamba_tail"] = _stack_specs(mc, tail)
        return out


# ---------------------------------------------------------------------------
# encoder-decoder (seamless-style; audio frontend stubbed as frame embeddings)
# ---------------------------------------------------------------------------


class EncDecLM(BaseLM):
    """A non-causal encoder over projected frame embeddings (`frame_proj`,
    rope on the frame positions, `enc_norm`) and a causal decoder whose
    layers add cross-attention to the encoder's output (`memory`). The
    cache holds `memory` beside the self-attention K/V: a forward given
    `frames` encodes them and copies the result into the cache; one
    without reads the cached memory. The loss is `BaseLM.loss` (no
    vision slice: the frontend is audio)."""

    def desc(self):
        cfg = self.cfg
        enc_layer = {"attn": blocks.desc_attn(cfg), "mlp": blocks.desc_mlp(cfg)}
        dec_layer = {"attn": blocks.desc_attn(cfg), "cross": blocks.desc_attn(cfg),
                     "mlp": blocks.desc_mlp(cfg)}
        out = self._embed_desc()
        out["enc_blocks"] = nn.stack_layers([enc_layer] * cfg.n_enc_layers)
        out["enc_norm"] = P((cfg.d_model,), ("norm",), "ones")
        out["dec_blocks"] = nn.stack_layers([dec_layer] * cfg.n_layers)
        return out

    def _enc_block(self, p, x, positions):
        a, _ = blocks.apply_attn(p["attn"], x, positions, self.cfg, causal=False)
        x = x + a
        return x + blocks.apply_mlp(p["mlp"], x, self.cfg)

    def encode(self, params, frames, remat: bool | None = None) -> torch.Tensor:
        """frames (B, M, d_model) -> the normed memory (B, M, d_model) in
        the compute dtype. With `remat` (default: `cfg.remat` under
        autograd) each layer runs under `torch.utils.checkpoint`."""
        cfg = self.cfg
        x = shard(dense(frames.to(_dt(cfg)), params["frame_proj"]), "batch", None, None)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        if remat is None:
            remat = cfg.remat and torch.is_grad_enabled()
        for p in nn.unstack(params["enc_blocks"], cfg.n_enc_layers):
            if remat:
                x = checkpoint(self._enc_block, p, x, positions, use_reentrant=False)
            else:
                x = self._enc_block(p, x, positions)
        return rms_norm(x, params["enc_norm"], cfg.norm_eps)

    def _dec_block(self, p, x, positions, memory, cache=None):
        cfg = self.cfg
        a, _ = blocks.apply_attn(p["attn"], x, positions, cfg, cache=cache)
        x = x + a
        c, _ = blocks.apply_attn(p["cross"], x, positions, cfg, memory=memory)
        x = x + c
        return x + blocks.apply_mlp(p["mlp"], x, cfg)

    def forward(self, params, batch, cache=None):
        cfg = self.cfg
        # training: each layer's activations are recomputed in the backward
        # (the reference's jax.checkpoint of the scanned layers)
        remat = cache is None and cfg.remat and torch.is_grad_enabled()
        if "frames" in batch:  # (re)encode; else reuse the cached memory
            memory = self.encode(params, batch["frames"], remat=remat)
        elif cache is not None:
            memory = cache["memory"]
        else:
            raise ValueError(f"{cfg.name}: a forward without a cache needs 'frames'")
        x = self._embed(params, batch)
        l = x.shape[1]
        clock = cache["pos"] if cache is not None else 0
        pos0 = nn.local_value(clock)  # a replicated clock's value on every rank
        positions = pos0 + torch.arange(l, device=x.device)[None, :]
        for i, p in enumerate(nn.unstack(params["dec_blocks"], cfg.n_layers)):
            if remat:
                x = checkpoint(self._dec_block, p, x, positions, memory, use_reentrant=False)
            else:
                x = _with_layer_cache(
                    lambda c: self._dec_block(p, x, positions, memory,
                                              None if c is None else dict(c, len=pos0)),
                    None if cache is None else cache["blocks"], i)
        new_cache = None
        if cache is not None:
            # the layers wrote their K/V rows into the cache stacks in place
            new_cache = dict(cache, pos=clock + l)
            if "frames" in batch:  # frames of `cache_desc`'s enc_len steps
                nn.write_state(cache["memory"], memory)
        return self._logits(params, x), new_cache

    def cache_desc(self, batch: int, max_len: int, enc_len: int | None = None):
        cfg = self.cfg
        enc_len = enc_len or cfg.frontend_len
        return {
            "pos": TensorSpec((), torch.int32),
            "memory": TensorSpec((batch, enc_len, cfg.d_model), _dt(cfg)),
            "blocks": _stack_specs(blocks.attn_cache_desc(cfg, batch, max_len), cfg.n_layers),
        }


def _with_layer_cache(fn, stack: dict | None, i: int):
    """`fn(layer i of the cache stack)` (`fn(None)` without a cache), whose
    blocks write their states into that layer in place; where a mesh
    splits the stack (a stack as long as the batch, `cache_sharding`), the
    gathered layer is written back to the ranks that hold it
    (`nn.put_layer`)."""
    if stack is None:
        return fn(None)
    cl = nn.layer(stack, i)
    out = fn(cl)
    nn.put_layer(stack, i, cl)
    return out


def build_model(cfg: ModelConfig, device=None) -> BaseLM:
    """The model for `cfg` on `device` (default the GPU): the decoder-only
    families (dense, MoE, MLA), xLSTM, the Zamba2-style hybrid and the
    encoder-decoder."""
    if cfg.encdec:
        return EncDecLM(cfg, device)
    if cfg.xlstm is not None:
        return XLSTMLM(cfg, device)
    if cfg.hybrid is not None:
        return HybridLM(cfg, device)
    return TransformerLM(cfg, device)
