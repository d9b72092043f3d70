"""Config-driven LM: specs, forward, prefill and decode for attention
stacks — decoder-only (stablelm; qwen2-7b and qwen2-vl-72b with a qkv bias,
the latter fed stub patch embeddings with M-RoPE position streams;
h2o-danube-1.8b with a sliding window; minitron-8b), encoder-decoder
(whisper: a bidirectional encoder over stub frames, a decoder with
cross-attention), the representation encoder (moment-large: bidirectional
over stub patch embeddings, pooled by the caller), MoE stacks (olmoe-1b-7b,
grok-1-314b), the Mamba + attention + MoE hybrid (jamba-v0.1-52b) and the
recurrent xLSTM stack (xlstm-125m).

Parameters are nested dicts/lists of tensors with the JAX package's structure
(``layers`` is a list over the period's sublayers, each leaf with a leading
``num_periods`` axis). Activations run in bf16, as in the JAX package; the
norms, the vocabulary head, the MoE router and the recurrences' gate and
decay leaves compute in f32. ``cast_params`` casts each weight once to the
dtype its use site computes in (``use_dtype``), so the per-use casts below
are no-ops on a served model.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.models import blocks as blk
from repro_torch.models.common import ParamSpec, init_params, stack_specs, tree_map
from repro_torch.models.layers import embed, embed_spec, head_spec, rmsnorm, rmsnorm_spec

ACT_DTYPE = torch.bfloat16


# ---------------- specs ----------------

def _encoder_layout(cfg: ModelConfig) -> list:
    return [blk.SubLayer(kind=ATTN, has_moe=False, has_ffn=cfg.d_ff > 0)]


def model_spec(cfg: ModelConfig) -> dict:
    """The parameter tree, as the JAX package's: an embed and a vocab head
    where ``vocab_size > 0``; a representation backbone's head is a (d, d)
    matrix in the vocab head's place. So full moment-large (vocab 0) has no
    embed, and its ``reduced`` cut (vocab 256) an unused one."""
    nper = cfg.num_layers // blk.period_len(cfg)
    layout = blk.period_layout(cfg, cross=cfg.is_encoder_decoder)
    spec = {
        "layers": [stack_specs(blk.sublayer_spec(cfg, lay), nper)
                   for lay in layout],
        "final_norm": rmsnorm_spec(cfg.d_model),
    }
    if cfg.vocab_size > 0:
        spec["embed"] = embed_spec(cfg.vocab_size, cfg.d_model)
        spec["head"] = head_spec(cfg.d_model, cfg.vocab_size)
    if cfg.is_representation:
        spec["head"] = ParamSpec((cfg.d_model, cfg.d_model), ("embed", None))
    if cfg.is_encoder_decoder:
        spec["encoder"] = {
            "layers": [stack_specs(blk.sublayer_spec(cfg, lay),
                                   cfg.encoder_layers)
                       for lay in _encoder_layout(cfg)],
            "final_norm": rmsnorm_spec(cfg.d_model),
        }
    return spec


# the leaves of a sublayer's mixer or feed-forward that their use site
# computes in f32 (the JAX package casts them with ``astype(float32)``)
F32_LEAVES = {"ffn": ("router",), "mamba": ("A_log", "D", "dt_bias"),
              "mlstm": ("b_if",), "slstm": ("r", "b")}
_BF16_PARTS = ("attn", "cross", "ffn", "mamba", "mlstm", "slstm")


def use_dtype(part: str, leaf: str):
    """The dtype a sublayer's ``part`` (``attn``, ``ffn``, ``mamba`` ...)
    uses its leaf ``leaf`` in: bf16 (the activations' dtype) for the
    matrices, None (kept f32) for the norms and ``F32_LEAVES``."""
    if part in _BF16_PARTS and leaf not in F32_LEAVES.get(part, ()):
        return ACT_DTYPE
    return None


def cast_params(params: dict) -> dict:
    """Cast each weight to the dtype of its use site (``use_dtype``): the
    embedding (where the tree has one) and the matrices of attention (self
    and cross), MLP, MoE experts, Mamba and xLSTM to bf16; the norms, the
    head, the MoE router and the f32 recurrence leaves kept f32 — in the
    decoder and in an encoder alike. The values are exactly those the JAX
    package computes with after its per-use ``astype``."""
    def cast(part, leaf, t):
        dt = use_dtype(part, leaf)
        return t if dt is None else t.to(dt)

    def layer(sub):
        return {k: {n: cast(k, n, t) for n, t in v.items()}
                if isinstance(v, dict) else v for k, v in sub.items()}
    out = dict(params)
    if "embed" in params:
        out["embed"] = params["embed"].to(ACT_DTYPE)
    out["layers"] = [layer(sub) for sub in params["layers"]]
    if "encoder" in params:
        out["encoder"] = dict(params["encoder"], layers=[
            layer(sub) for sub in params["encoder"]["layers"]])
    return out


def init_model(gen: Optional[torch.Generator], cfg: ModelConfig,
               device="cuda", masters: bool = False) -> dict:
    """Random weights from ``gen``: f32 draws in the spec's leaf order, each
    leaf cast to its use-site dtype (``use_dtype``) as it is drawn, so
    the peak is the served weights plus one f32 leaf (a minitron-8b drawn
    whole in f32 would hold 40 GB before the cast). With ``masters`` every
    leaf keeps its f32 draw: the trainer's master weights (the JAX
    package's ``init_model`` tree, which its trainer trains); the forward
    casts each at its use site, so gradients reach the f32 leaves."""
    def dt(part, leaf):
        return None if masters else use_dtype(part, leaf)

    def layers(subs):
        return [{k: {n: init_params(gen, s, device=device, dtype=dt(k, n))
                     for n, s in v.items()} if isinstance(v, dict)
                 else init_params(gen, v, device=device)
                 for k, v in sub.items()} for sub in subs]
    out = {}
    for name, sub in model_spec(cfg).items():
        if name == "layers":
            out[name] = layers(sub)
        elif name == "encoder":
            out[name] = {k: layers(v) if k == "layers" else
                         init_params(gen, v, device=device)
                         for k, v in sub.items()}
        else:
            out[name] = init_params(gen, sub, device=device,
                                    dtype=ACT_DTYPE if name == "embed"
                                    and not masters else None)
    return out


def cache_spec(cfg: ModelConfig, batch: int, s_max: int,
               kv_quant: bool = False, paged: bool = False,
               page_size: int = 16, num_pages: int = 0,
               enc_len: Optional[int] = None) -> list:
    """Stacked per-period decode cache (list over sublayers).
    ``kv_quant``: int8 K/V + per-(batch, kv-head) scales. ``paged``: the
    int8 page arena of ``num_pages`` pages of ``page_size`` positions plus a
    per-row page table (``blocks.sublayer_cache_spec``); ``s_max`` then
    bounds only the table width. ``enc_len``: encoder frames of the
    cross-attention K/V state of an encoder-decoder stack (default
    ``s_max``): the serving engine passes its fixed frame count, so the
    per-slot cross state is sized to the audio frontend, not to the decode
    budget."""
    nper = cfg.num_layers // blk.period_len(cfg)
    if not cfg.is_encoder_decoder:
        enc_len = 0
    elif enc_len is None:
        enc_len = s_max
    return [stack_specs(blk.sublayer_cache_spec(
        cfg, lay, batch, s_max, enc_len=enc_len, kv_quant=kv_quant,
        paged=paged, page_size=page_size, num_pages=num_pages), nper)
        for lay in blk.period_layout(cfg, cross=cfg.is_encoder_decoder)]


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               kv_quant: bool = False, paged: bool = False,
               page_size: int = 16, num_pages: int = 0,
               enc_len: Optional[int] = None, device="cuda"):
    return init_params(None, cache_spec(cfg, batch, s_max, kv_quant=kv_quant,
                                        paged=paged, page_size=page_size,
                                        num_pages=num_pages, enc_len=enc_len),
                       device=device)


# ---------------- stack forward ----------------

def _at(tree, i):
    return tree_map(lambda t: t[i], tree)


def _stack_forward(layers_p, layout, x, cfg, *, mode, cache, pos, causal,
                   pos3=None, enc_out=None, lora=None, adapter_idx=None,
                   lora_impl="gather", lora_seg=None, seq_lens=None,
                   prefix=None, prefix_len=None, remat=False, aux=None):
    """Loop over periods and their sublayers (the JAX package scans). A
    decode step over cross-attention sublayers builds the (B,) frame-count
    vector once, on the device, for every layer. Training only: ``aux``, a
    list, receives each period's MoE aux loss (summed over its
    sublayers), and ``remat`` recomputes each period's activations in the
    backward (``torch.utils.checkpoint``; JAX's ``jax.checkpoint`` of the
    scanned period)."""
    nper = layers_p[0]["ln1"].shape[0]
    cross_len = None
    if mode == "decode" and any(lay.has_cross for lay in layout):
        ck = next(c["ck"] for c, lay in zip(cache, layout) if lay.has_cross)
        cross_len = torch.full((ck.shape[1],), ck.shape[2],
                               dtype=torch.int32, device=ck.device)

    def period(i, x, period_aux):
        for j, lay in enumerate(layout):
            x = blk.sublayer_apply(
                _at(layers_p[j], i), x, cfg, lay, mode=mode,
                cache=None if cache is None else _at(cache[j], i), pos=pos,
                pos3=pos3, causal=causal, enc_out=enc_out, cross_len=cross_len,
                lora=_at(lora[j], i) if lora is not None and lora[j] else None,
                adapter_idx=adapter_idx, lora_impl=lora_impl,
                lora_seg=lora_seg, seq_lens=seq_lens,
                prefix=_at(prefix[j], i) if prefix is not None and prefix[j]
                else None, prefix_len=prefix_len, aux=period_aux)
        return x

    def with_aux(i, x):
        got = []
        x = period(i, x, got)
        return x, (torch.stack(got).sum() if got else
                   torch.zeros((), device=x.device))

    for i in range(nper):
        if remat:
            x, a = checkpoint(with_aux, i, x, use_reentrant=False)
        elif aux is not None:
            x, a = with_aux(i, x)
        else:
            x = period(i, x, None)
            continue
        if aux is not None:
            aux.append(a)
    return x


def encode(params, cfg: ModelConfig, enc_embeds, remat: bool = False):
    """The encoder of an encoder-decoder stack: bidirectional attention
    sublayers over the stub frontend's frames (B, S_enc, d), RoPE at
    positions 0..S_enc-1, no LoRA, then the encoder's final norm."""
    e = enc_embeds.to(ACT_DTYPE)
    e_pos = torch.arange(e.shape[1], device=e.device)[None]
    e = _stack_forward(params["encoder"]["layers"], _encoder_layout(cfg), e,
                       cfg, mode="full", cache=None, pos=e_pos, causal=False,
                       remat=remat)
    return rmsnorm(params["encoder"]["final_norm"], e, cfg.norm_eps)


def forward(params, cfg: ModelConfig, *, tokens=None, embeds=None, cache=None,
            mode: str = "full", pos=None, pos3=None, enc_embeds=None,
            lora=None, adapter_idx=None, lora_impl: str = "gather",
            lora_seg=None, seq_lens=None, prefix=None, prefix_len=None,
            remat: bool = False, aux=None):
    """Backbone forward. Returns (hidden (B, S, d), cache). Inputs are
    ``tokens`` (B, S) int or ``embeds`` (B, S, d); an encoder-decoder stack
    also takes ``enc_embeds`` (B, S_enc, d) outside decode (a decode step
    reads the cross K/V its prefill stored in the cache). ``cache``
    (prefill / decode) is updated in place. ``lora_impl`` "gather" or
    "segmented" (the latter needs ``lora_seg`` metadata); ``seq_lens`` (B,)
    masks right pads. ``pos3`` (B, S, 3): the M-RoPE position streams of
    an M-RoPE config (qwen2-vl: a vision patch's t/h/w), taken in place of
    RoPE at ``pos`` (without them 'full' mode rotates by ``pos``, and
    decode and verify by t = h = w = the text position).

    ``prefix``/``prefix_len``: chunked shared-prefix prefill — a list
    aligned with the period layout of per-sublayer dict(k, v) precomputed
    prefix K/V (leading ``num_periods`` axis, like ``cache``; None for a
    sublayer without attention) that every attention sublayer attends to in
    front of its own keys. Pass absolute ``pos`` (``prefix_len +
    arange(S)``) so RoPE matches.

    Training (``loss_fn``): ``remat`` recomputes each period in the
    backward (the encoder's too); ``aux``, a list, receives the MoE aux
    loss of each period (serving passes neither, so its executables and
    outputs are as without them)."""
    enc_out = None
    if cfg.is_encoder_decoder and mode != "decode":
        if enc_embeds is None:
            raise ValueError(f"{cfg.name} is encoder-decoder: forward needs "
                             f"enc_embeds")
        enc_out = (encode(params, cfg, enc_embeds, remat=True) if remat
                   else encode(params, cfg, enc_embeds))
    if embeds is None:
        x = embed(params["embed"].to(ACT_DTYPE), tokens)
    else:
        x = embeds.to(ACT_DTYPE)
    if pos is None and mode not in ("decode", "verify"):
        pos = torch.arange(x.shape[1], device=x.device)[None]
    x = _stack_forward(params["layers"],
                       blk.period_layout(cfg, cross=cfg.is_encoder_decoder),
                       x, cfg, mode=mode, cache=cache, pos=pos, pos3=pos3,
                       causal=not cfg.is_representation, enc_out=enc_out,
                       lora=lora, adapter_idx=adapter_idx,
                       lora_impl=lora_impl, lora_seg=lora_seg,
                       seq_lens=seq_lens, prefix=prefix,
                       prefix_len=prefix_len, remat=remat, aux=aux)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), cache


# ---------------- losses ----------------

def chunked_ce_loss(head_w, x, labels, weights, chunk: int = 512,
                    true_vocab: Optional[int] = None):
    """Cross-entropy of the vocabulary head over sequence chunks (the JAX
    package's ``chunked_ce_loss``): x (B, S, d), labels and weights (B, S);
    the chunk is ``min(S, chunk)`` lowered until it divides S. Logits are
    f32 (x and ``head_w`` taken to f32; a product that must not run in
    TF32 on the card); vocabulary entries at and past ``true_vocab`` get
    -1e30. Each chunk is recomputed in the backward
    (``torch.utils.checkpoint``), so no (B, S, V) logits stay alive.
    Returns the weighted sum over max(sum(weights), 1)."""
    B, S, d = x.shape
    V = head_w.shape[-1]
    c = min(S, chunk)
    while S % c:
        c -= 1
    pad = None
    if true_vocab is not None and true_vocab < V:
        pad = torch.where(torch.arange(V, device=x.device) < true_vocab,
                          0.0, -1e30)

    def step(xc, lc, wc):
        logits = xc.float() @ head_w.float()
        if pad is not None:
            logits = logits + pad
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
        return torch.sum((lse - gold) * wc)

    tot = torch.zeros((), device=x.device)
    for i in range(0, S, c):
        tot = tot + checkpoint(step, x[:, i:i + c], labels[:, i:i + c],
                               weights[:, i:i + c], use_reentrant=False)
    return tot / torch.clamp(torch.sum(weights), min=1.0)


def loss_fn(params, cfg: ModelConfig, batch: dict, remat: bool = True,
            aux_weight: float = 0.01):
    """The training loss of the JAX package's ``loss_fn``: (loss, metrics).
    ``batch``: ``tokens`` | ``embeds`` (+ ``labels``), ``enc_embeds``,
    ``pos3``, as tensors on the params' device. A representation config
    (moment) reconstructs its input embeddings (MSE of ``x @ head``,
    MOMENT-style); with ``labels`` each position predicts its label;
    otherwise the next token, the last position weighted 0. The MoE aux
    loss, summed over the layers, adds ``aux_weight`` times itself."""
    tokens, embeds = batch.get("tokens"), batch.get("embeds")
    auxs = []
    x, _ = forward(params, cfg, tokens=tokens, embeds=embeds,
                   enc_embeds=batch.get("enc_embeds"), pos3=batch.get("pos3"),
                   remat=remat, aux=auxs)
    aux = torch.stack(auxs).sum() if auxs else torch.zeros((),
                                                           device=x.device)
    if cfg.is_representation:
        recon = x @ params["head"].to(x.dtype)
        loss = torch.mean((recon.float() - embeds.float()) ** 2)
        return loss, {"loss": loss, "aux": aux}
    if "labels" in batch:
        labels = batch["labels"]
        weights = torch.ones(labels.shape, device=x.device)
    else:
        labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        weights = torch.ones(tokens.shape, device=x.device)
        weights[:, -1] = 0.0
    ce = chunked_ce_loss(params["head"], x, labels, weights,
                         true_vocab=cfg.true_vocab)
    loss = ce + aux_weight * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


# ---------------- serving steps ----------------

def finite_logits(logits):
    """True iff every logit of the row is finite: (B,) for (B, V) logits,
    (B, T) for a verify window's (B, T, V)."""
    return torch.isfinite(logits.float()).all(dim=-1)


def _head(params, x):
    return x.float() @ params["head"].float()


def prefill(params, cfg: ModelConfig, *, tokens=None, embeds=None,
            enc_embeds=None, pos3=None, cache, lora=None, adapter_idx=None,
            lora_impl: str = "gather", lora_seg=None, seq_lens=None, pos=None,
            prefix=None, prefix_len=None):
    """Fill the decode cache from a prompt (in place). Returns
    (last_logits (B, V) f32, cache). ``seq_lens`` (B,): true lengths of
    right-padded prompts; the logits come from each row's last real token.
    ``embeds`` (B, S, d) in place of ``tokens`` (a stub frontend's patch
    embeddings) and ``pos3`` (B, S, 3) as in ``forward``.
    An encoder-decoder stack encodes ``enc_embeds`` (B, enc_len, d) here and
    stores every cross-attention sublayer's K/V of it in the cache.

    Chunked shared-prefix admission passes ``tokens`` holding only the
    PRIVATE TAIL plus ``prefix``/``prefix_len``/``pos``: ``prefix`` is the
    per-sublayer K/V of the already-mapped shared pages (see ``forward``),
    ``pos = prefix_len + arange(tail)`` keeps RoPE at absolute positions,
    ``seq_lens`` counts TAIL tokens only, and the cache receives only the
    tail's K/V — the engine scatters it after the prefix pages in the
    slot's page table."""
    x, cache = forward(params, cfg, tokens=tokens, embeds=embeds, cache=cache,
                       mode="full", pos3=pos3, enc_embeds=enc_embeds,
                       lora=lora, adapter_idx=adapter_idx,
                       lora_impl=lora_impl, lora_seg=lora_seg,
                       seq_lens=seq_lens, pos=pos, prefix=prefix,
                       prefix_len=prefix_len)
    if seq_lens is None:
        last = x[:, -1]
    else:
        rows = torch.arange(x.shape[0], device=x.device)
        last = x[rows, torch.clamp(seq_lens, min=1).long() - 1]
    return _head(params, last), cache


def decode_step(params, cfg: ModelConfig, *, tokens=None, embeds=None, cache,
                lora=None, adapter_idx=None, lora_impl: str = "gather",
                lora_seg=None):
    """One-token serve step. tokens: (B,) int or embeds: (B, d). Returns
    (logits (B, V) f32, cache) with the cache advanced in place."""
    if embeds is None:
        x = embed(params["embed"].to(ACT_DTYPE), tokens[:, None])
    else:
        x = embeds[:, None].to(ACT_DTYPE)
    x, cache = forward(params, cfg, embeds=x, cache=cache, mode="decode",
                       lora=lora, adapter_idx=adapter_idx,
                       lora_impl=lora_impl, lora_seg=lora_seg)
    return _head(params, x[:, 0]), cache


def verify_step(params, cfg: ModelConfig, *, tokens, cache, lora=None,
                adapter_idx=None, lora_impl: str = "gather", lora_seg=None):
    """Speculative verify: score T = k + 1 positions in one batched forward.

    tokens: (B, T) int; column 0 is the slot's last sampled token (what a
    plain ``decode_step`` would feed), columns 1..k the drafted
    continuation, every id inside the vocabulary (the engine clamps its
    out-of-vocab draft sentinel before the embedding gather). Returns
    (logits (B, T, V) f32, cache): ``logits[:, j]`` is what a sequential
    ``decode_step`` walk would produce after feeding ``tokens[:, :j+1]``
    (the same embedding rows, the same per-position paged attention, the
    same f32 head), up to the rounding of dense products over B * T rows
    instead of B. The cache advances in place by the whole window; the
    caller rolls each slot back to its commit point through the cache's
    ``k_cmax``/``v_cmax`` stacks and ``len``."""
    x = embed(params["embed"].to(ACT_DTYPE), tokens)
    x, cache = forward(params, cfg, embeds=x, cache=cache, mode="verify",
                       lora=lora, adapter_idx=adapter_idx,
                       lora_impl=lora_impl, lora_seg=lora_seg)
    return _head(params, x), cache


def backbone_features(params, cfg: ModelConfig, embeds):
    """Representation-FM forward (MOMENT-style): patch embeddings (B, S, d)
    -> final-norm features (B, S, d), bidirectional attention (K2 with
    ``causal=False``)."""
    x, _ = forward(params, cfg, embeds=embeds)
    return x
