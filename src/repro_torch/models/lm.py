"""Model assembly: embedding -> block groups -> head.

The twin of ``repro.models.lm``, for all ten of its configs.
:class:`LanguageModel` is an ``nn.Module`` on an explicit
device and dtype that holds one parameter per declared tensor, in
``repro``'s einsum layouts.  ``repro`` stacks each layer group on a
leading axis and ``lax.scan``s over it; the port keeps one tensor per
layer and loops over the layers.  Its flat names are ``repro``'s keys with
the layer index inserted after the group (``dec/g0/3/b0:attn_local/attn/wq``
is row 3 of ``repro``'s ``dec/g0/b0:attn_local/attn/wq``); see
:meth:`LanguageModel.reference_names`.  A kind of ``cfg.shared_blocks``
(zamba2's ``attn_shared``) has one parameter set, ``shared/<kind>/...``,
outside the groups, run at every position of the pattern that names it
(so its gradients sum over the uses); each position keeps its own cache.

The per-layer parameters are views of one tensor per ``repro`` key, in
``repro``'s stacked layout (:meth:`LanguageModel.stacked_dict`), which is
what the trainer holds; :meth:`LanguageModel.unstack` maps such a stacked
dict to the per-layer one with one ``torch.unbind`` a key.

The methods are functional in the parameters, as ``repro``'s: each takes a
``{name: tensor}`` dict (:meth:`LanguageModel.param_dict`, or a cast of it
from ``train.steps.cast_tree``).  Caches keep ``repro``'s layout (a list
per group of ``{bkey: {"k": (L, B, Smax, Hkv, Dh), ...}}``, the sLSTM's
carry a list of four); decode writes them in place.  Remat (``repro``'s
``jax.checkpoint`` of each layer) runs when ``cfg.remat`` is set and grad
is enabled: ``remat_policy="dots"`` saves the matmul outputs and
recomputes the rest, any other policy (``"all"``, ``"none"``: save
nothing) recomputes the whole layer, as ``repro``'s ``policy=None``.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks, common
from repro_torch.models.attention import TensorSpec
from repro_torch.sharding.placement import Sharded, Split
from repro_torch.models.params import (
    ParamDecl,
    ParamTable,
    abstract_params,
    init_one,
    logical_axes,
    merge_tables,
    num_params,
    prefix_table,
    stack_table,
)


def _enc_pattern(cfg: ModelConfig):
    return ((cfg.n_enc_layers, ("attn_bidir",)),) if cfg.n_enc_layers else ()


def param_table(cfg: ModelConfig) -> ParamTable:
    """``repro``'s flat table: layer groups stacked on a leading axis."""
    t: ParamTable = {
        "embed/tokens": ParamDecl((cfg.vocab_size, cfg.d_model),
                                  ("vocab", "embed"), init="embed"),
        "final_norm": ParamDecl((cfg.d_model,), ("embed",), init="zeros"),
    }
    if not cfg.tie_embeddings:
        t["unembed"] = ParamDecl((cfg.d_model, cfg.vocab_size),
                                 ("embed", "vocab"), init="output")
    for gi, (repeat, kinds) in enumerate(cfg.pattern):
        group: ParamTable = {}
        for bi, kind in enumerate(kinds):
            if kind in cfg.shared_blocks:
                continue
            group = merge_tables(
                group,
                prefix_table(f"b{bi}:{kind}",
                             blocks.block_param_table(cfg, kind)),
            )
        t.update(prefix_table(f"dec/g{gi}", stack_table(group, repeat)))
    for kind in cfg.shared_blocks:
        t.update(prefix_table(f"shared/{kind}",
                              blocks.block_param_table(cfg, kind)))
    for gi, (repeat, kinds) in enumerate(_enc_pattern(cfg)):
        group = prefix_table("b0:attn_bidir",
                             blocks.block_param_table(cfg, "attn_bidir"))
        t.update(prefix_table(f"enc/g{gi}", stack_table(group, repeat)))
    if cfg.n_enc_layers:
        t["enc_pos"] = ParamDecl((cfg.enc_seq, cfg.d_model),
                                 (None, "embed"), init="embed")
        t["enc_final_norm"] = ParamDecl((cfg.d_model,), ("embed",),
                                        init="zeros")
    return t


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "LanguageModel runs on the card by default and found no CUDA "
                "device; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _tree_map(fn, tree):
    """``fn`` on every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _layer_view(cache, li: int):
    """The per-layer views of a stacked cache tree."""
    return _tree_map(lambda t: t[li], cache)


class LanguageModel(nn.Module):
    """A ``ModelConfig``'s language model on ``device`` (the card when None;
    ``"meta"`` allocates nothing) with parameters of ``dtype``.  The
    parameters start at zero: fill them with :meth:`init` or
    ``interop.params_from_reference``.
    """

    def __init__(self, cfg: ModelConfig, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.device = _resolve_device(device)
        # Port name -> (repro key, layer row or None), and the port's own
        # (per-layer) decls.
        self._reference: dict[str, tuple[str, int | None]] = {}
        self._decls: ParamTable = {}
        # scope -> [group][layer] -> {bkey: {path within block: port name}}
        self._layers: dict[str, list[list[dict]]] = {"dec": [], "enc": []}
        # shared kind -> {path within block: port name}
        self._shared: dict[str, dict[str, str]] = {}
        # repro key -> its tensor; each port parameter is a view of one.
        self._stacked: dict[str, torch.Tensor] = {}
        for key, decl in param_table(cfg).items():
            self._stacked[key] = torch.zeros(decl.shape, dtype=dtype,
                                             device=self.device)
            scope = key.split("/", 1)[0]
            if scope not in ("dec", "enc"):
                self._reference[key] = (key, None)
                self._decls[key] = decl
                if scope == "shared":
                    _, kind, path = key.split("/", 2)
                    self._shared.setdefault(kind, {})[path] = key
                continue
            _, group, bkey, path = key.split("/", 3)
            gi = int(group[1:])
            layers = self._layers[scope]
            while len(layers) <= gi:
                layers.append([])
            one = ParamDecl(decl.shape[1:], decl.axes[1:], decl.init,
                            decl.fan_in)
            for li in range(decl.shape[0]):
                name = f"{scope}/{group}/{li}/{bkey}/{path}"
                self._reference[name] = (key, li)
                self._decls[name] = one
                while len(layers[gi]) <= li:
                    layers[gi].append({})
                layers[gi][li].setdefault(bkey, {})[path] = name
        self.weights = nn.ParameterDict({
            name: nn.Parameter(self._row(*self._reference[name]))
            for name in sorted(self._decls)})

    def _row(self, key: str, row: int | None) -> torch.Tensor:
        return self._stacked[key] if row is None else self._stacked[key][row]

    # -- parameters ------------------------------------------------------------

    def param_table(self) -> ParamTable:
        """``repro``'s table (stacked layer groups)."""
        return param_table(self.cfg)

    def layer_table(self) -> ParamTable:
        """The port's table: one decl per parameter, by port name."""
        return dict(self._decls)

    def reference_names(self) -> dict[str, tuple[str, int | None]]:
        """Port name -> (``repro``'s flat key, the row of its stacked layer
        axis, or None for an unstacked parameter)."""
        return dict(self._reference)

    def param_dict(self) -> dict[str, torch.Tensor]:
        """``{port name: parameter}``, the argument of the methods below."""
        return dict(self.weights.items())

    def stacked_dict(self) -> dict[str, torch.Tensor]:
        """``{repro key: tensor}`` in ``repro``'s stacked layout (layer groups
        on a leading axis); :meth:`param_dict`'s parameters are views of
        these tensors."""
        return dict(self._stacked)

    def unstack(self, stacked: dict) -> dict[str, torch.Tensor]:
        """A dict in :meth:`stacked_dict`'s layout as the per-layer dict the
        methods take.  Each stacked tensor is unbound once (its backward is
        one ``stack``; indexing it a layer at a time would allocate a
        zero-filled gradient of the whole stack for every layer)."""
        rows = {}
        out = {}
        for name, (key, row) in self._reference.items():
            if row is None:
                out[name] = stacked[key]
                continue
            if key not in rows:
                rows[key] = torch.unbind(stacked[key])
            out[name] = rows[key][row]
        return out

    def n_params(self) -> int:
        return num_params(self.param_table())

    def release(self) -> "LanguageModel":
        """Drop the parameter tensors, keeping the structure: a mesh
        program (:class:`MeshLM`) reads the parameters it is given, so once
        they are placed on a mesh the model's own copy can go."""
        self._stacked = {}
        self.weights = nn.ParameterDict()
        return self

    def abstract(self, dtype=torch.float32) -> dict:
        """``repro``'s table as ``"meta"`` tensors (no allocation)."""
        return abstract_params(self.param_table(), dtype)

    def axes(self) -> dict:
        """``repro``'s key -> logical axis names."""
        return logical_axes(self.param_table())

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "LanguageModel":
        """Draw every parameter by ``repro``'s rules (``params.init_one``)
        from ``generator``, in sorted port-name order.  The draws are made
        on the generator's device."""
        for name in sorted(self._decls):
            init_one(self._decls[name], self.weights[name].data, generator)
        return self

    # -- group plumbing --------------------------------------------------------

    def _layer_params(self, params: dict, scope: str, gi: int,
                      li: int) -> dict:
        """``{bkey: {path within block: tensor}}`` of one layer; a shared
        kind's block reads the one ``shared/<kind>/...`` set."""
        out = {bkey: {path: params[name] for path, name in paths.items()}
               for bkey, paths in self._layers[scope][gi][li].items()}
        if scope == "dec":
            for bi, kind in enumerate(self.cfg.pattern[gi][1]):
                if kind in self.cfg.shared_blocks:
                    out[f"b{bi}:{kind}"] = {
                        path: params[name]
                        for path, name in self._shared[kind].items()}
        return out

    def _run_groups(self, params, x, ctx, pattern, scope, sink=None,
                    layer_fn=None, device=None):
        """Every layer of ``pattern`` in order through ``layer_fn`` (default
        :meth:`_layer`; ``MeshLM``'s runs a layer over the mesh rows, ``x``
        and ``ctx`` then a list a row, the aux on ``device``); ``sink(gi, li,
        bkey, kind, kv)`` receives each block's cache payload.  Each layer
        is checkpointed (remat) when ``cfg.remat`` is set, grad is enabled
        and no payload is wanted."""
        cfg = self.cfg
        layer_fn = layer_fn or self._layer
        remat = cfg.remat and sink is None and torch.is_grad_enabled()
        aux_total = torch.zeros((), dtype=torch.float32,
                                device=device or x.device)
        for gi, (repeat, kinds) in enumerate(pattern):
            for li in range(repeat):
                layer = self._layer_params(params, scope, gi, li)
                if remat:
                    x, aux = _checkpoint(cfg.remat_policy, layer_fn, layer,
                                         kinds, x, ctx)
                else:
                    x, aux = layer_fn(layer, kinds, x, ctx, sink, gi, li)
                aux_total = aux_total + aux
        return x, aux_total

    def _layer(self, layer, kinds, x, ctx, sink=None, gi=0, li=0):
        """One layer of a group: its blocks in order (``repro``'s scan
        body).  Returns ``(x, aux)``."""
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for bi, kind in enumerate(kinds):
            bkey = f"b{bi}:{kind}"
            x, aux, kv = blocks.apply_block(self.cfg, kind, layer[bkey], x,
                                            ctx)
            aux_total = aux_total + aux
            if sink is not None:
                sink(gi, li, bkey, kind, kv)
        return x, aux_total

    # -- embedding / head -------------------------------------------------------

    def _embed(self, params, tokens):
        return _embed(self.cfg, Split((params["embed/tokens"],), None), tokens)

    def _head(self, params, x):
        key = "embed/tokens" if self.cfg.tie_embeddings else "unembed"
        return _head(self.cfg, x, params["final_norm"],
                     Split((params[key],), None))

    def _encode(self, params, frames):
        """Audio encoder over precomputed frame embeddings (frontend stub)."""
        x, ectx = _enc_input(params["enc_pos"], frames)
        x, _ = self._run_groups(params, x, ectx, _enc_pattern(self.cfg), "enc")
        return common.rms_norm(x, params["enc_final_norm"], self.cfg.norm_eps)

    def _context(self, params, batch, seq_len, stats=None):
        cfg = self.cfg
        kv_src = None
        if cfg.family == "audio":
            kv_src = self._encode(params, batch["frames"])
        elif cfg.family == "vlm":
            kv_src = batch["images"]
        return {"positions": _positions(batch["tokens"], seq_len),
                "kv_src": kv_src, "stats": stats}

    # -- training loss -----------------------------------------------------------

    def loss(self, params, batch):
        """batch: tokens (B,S) int, labels (B,S) int (-1 = masked)."""
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        ctx = self._context(params, batch, tokens.shape[1])
        x, aux = self._run_groups(params, x, ctx, self.cfg.pattern, "dec")
        ll, count = _ll_sum(self._head(params, x), batch["labels"])
        ce = -ll / torch.clamp(count, min=1.0)
        return ce + aux, {"ce": ce, "aux": aux}

    # -- serving -----------------------------------------------------------------

    def cache_spec(self, batch: int, smax: int, dtype):
        """A list per group of ``{bkey: {name: TensorSpec}}``, each tensor
        stacked on a leading layer axis (``repro``'s layout)."""
        cfg = self.cfg

        return [{f"b{bi}:{kind}": _tree_map(
                    lambda s, r=repeat: TensorSpec((r, *s.shape), s.dtype),
                    blocks.block_cache_spec(cfg, kind, batch, smax, dtype))
                 for bi, kind in enumerate(kinds)}
                for repeat, kinds in cfg.pattern]

    def init_cache(self, batch: int, smax: int, dtype):
        return _tree_map(
            lambda s: torch.zeros(s.shape, dtype=s.dtype, device=self.device),
            self.cache_spec(batch, smax, dtype))

    @torch.no_grad()
    def decode_step(self, params, caches, token, pos, kv_ctx=None,
                    stats=None):
        """token: (B,) int; pos: int. Returns (logits (B,V), caches).

        ``caches`` (``cache_spec``'s layout) are updated in place at ``pos``
        and returned; the cross-attention caches in them are static (written
        by prefill).  ``stats``: a dict the MoE layers add their dropped
        (token, choice) pairs to (``moe.moe``).
        """
        cfg = self.cfg
        pos = int(pos)
        x = self._embed(params, token[:, None])
        ctx = {"pos": pos, "kv_src": kv_ctx, "stats": stats}
        for gi, (repeat, kinds) in enumerate(cfg.pattern):
            for li in range(repeat):
                layer = self._layer_params(params, "dec", gi, li)
                for bi, kind in enumerate(kinds):
                    bkey = f"b{bi}:{kind}"
                    x, _ = blocks.decode_block(
                        cfg, kind, layer[bkey], x,
                        _layer_view(caches[gi][bkey], li), ctx)
        logits = self._head(params, x[:, 0])
        return logits, caches

    @torch.no_grad()
    def prefill(self, params, batch, smax, cache_dtype=None, stats=None):
        """Run the full prompt, return (last-token logits, filled caches).

        The caches are allocated first (zeros of ``smax``, in
        ``cache_dtype`` or the embedding's dtype) and each layer writes its
        payload as it runs, so no layer's payload outlives it.  ``stats`` as
        in :meth:`decode_step`.
        """
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        dtype = cache_dtype or params["embed/tokens"].dtype
        caches = self.init_cache(b, smax, dtype)

        def sink(gi, li, bkey, kind, payload):
            _payload_to_cache(cfg, kind, payload,
                              _layer_view(caches[gi][bkey], li), s)

        x = self._embed(params, tokens)
        ctx = self._context(params, batch, s, stats)
        x, _ = self._run_groups(params, x, ctx, cfg.pattern, "dec", sink)
        logits = self._head(params, x[:, -1])
        return logits, caches


def _positions(tokens, seq_len: int) -> torch.Tensor:
    """``[0, seq_len)`` for each batch row of ``tokens``."""
    return torch.arange(seq_len, device=tokens.device)[None].expand(
        tokens.shape[0], seq_len)


def _embed(cfg: ModelConfig, table: Split, tokens) -> torch.Tensor:
    """The embedding of ``tokens`` (scaled as ``cfg`` says) from ``table``,
    whole or split over a row's devices by vocab: each part looks up the
    tokens in its own range and the results are summed."""
    if table.dim is None:
        x = table.parts[0][tokens]
    else:
        x = None
        for m, w in enumerate(table.parts):
            lo, hi = table.bounds(m)
            t = tokens.to(w.device)
            hit = (t >= lo) & (t < hi)
            e = w[torch.clamp(t - lo, 0, hi - lo - 1)]
            e = torch.where(hit[..., None], e,
                            torch.zeros((), dtype=e.dtype, device=e.device))
            x = e.to(tokens.device) if x is None else x + e.to(tokens.device)
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return x


def _head(cfg: ModelConfig, x, norm, w: Split) -> torch.Tensor:
    """Final norm, the output projection (``w``: the unembedding, or the
    tied embedding table) and the final softcap.  A ``w`` split by vocab
    over a row's devices gives each its logits, concatenated on x's
    device before the softcap."""
    x = common.rms_norm(x, norm, cfg.norm_eps)
    ws = [p.T for p in w.parts] if cfg.tie_embeddings else list(w.parts)
    if w.dim is None:
        logits = common.matmul(x, ws[0]).float()
    else:
        logits = torch.cat([common.matmul(x.to(p.device), p).to(x.device)
                            for p in ws], dim=-1).float()
    if cfg.final_softcap is not None:
        logits = common.softcap(logits, cfg.final_softcap)
    return logits


def _enc_input(enc_pos, frames):
    """The audio encoder's input (frames plus positions) and context."""
    x = frames + enc_pos[None, : frames.shape[1]].to(frames.dtype)
    pos = torch.arange(frames.shape[1], device=frames.device)[None].expand(
        frames.shape[:2])
    return x, {"positions": pos, "kv_src": None}


def _ll_sum(logits, labels):
    """The sum of the labelled tokens' log-likelihoods (-1 = masked) and
    their count."""
    mask = (labels >= 0).float()
    logp = F.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    return torch.sum(ll * mask), torch.sum(mask)


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy (``jax.checkpoint_policies.checkpoint_dots``):
    save what the matrix products output, recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
              torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpoint(policy: str, fn, *args):
    """``fn(*args)`` under activation checkpointing: ``policy="dots"``
    saves the matrix products' outputs, any other saves nothing."""
    from torch.utils import checkpoint

    kwargs = {}
    if policy == "dots":
        kwargs["context_fn"] = functools.partial(
            checkpoint.create_selective_checkpoint_contexts, _save_dots)
    return checkpoint.checkpoint(fn, *args, use_reentrant=False, **kwargs)


def _scatter_seq(cache_arr, kv, s):
    """kv: (B, S, ...) -> written at positions [0, S) of one layer's cache
    (B, Smax, ...), in the cache's dtype."""
    cache_arr[:, :s] = kv.to(cache_arr.dtype)
    return cache_arr


def _payload_to_cache(cfg, kind, payload, cache, s):
    """Write one layer's prefill payload into its cache views."""
    if kind in blocks._ATTN_KINDS:
        k, v = payload
        return {"k": _scatter_seq(cache["k"], k, s),
                "v": _scatter_seq(cache["v"], v, s)}
    if kind in ("mla", "mla_moe"):
        latent, k_rope = payload
        return {"latent": _scatter_seq(cache["latent"], latent, s),
                "k_rope": _scatter_seq(cache["k_rope"], k_rope, s)}
    if kind == "cross":
        k, v = payload
        cache["k"].copy_(k)
        cache["v"].copy_(v)
        return cache
    if kind == "dec_cross":
        (k, v), (kx, vx) = payload
        cache["cross"]["k"].copy_(kx)
        cache["cross"]["v"].copy_(vx)
        return {
            "self": {"k": _scatter_seq(cache["self"]["k"], k, s),
                     "v": _scatter_seq(cache["self"]["v"], v, s)},
            "cross": cache["cross"],
        }
    if kind in ("mamba", "mlstm"):
        return blocks._write(cache, payload)
    if kind == "slstm":
        return blocks._write(cache, {"carry": list(payload)})
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Over a mesh (train.steps.build_programs)
# ---------------------------------------------------------------------------


def _row_slices(n: int, rows: int) -> list:
    """Each data row's slice of ``n`` batch rows: equal slices, or the whole
    batch in every row when ``rows`` does not divide it (its cache spec then
    replicates the batch, ``train.steps.prune_specs``)."""
    if n % rows:
        return [slice(None)] * rows
    k = n // rows
    return [slice(r * k, (r + 1) * k) for r in range(rows)]


class _Layers(tuple):
    """A cache leaf's :class:`Split`s, ``[layer][row]``."""


class MeshLM:
    """A :class:`LanguageModel`'s loss, prefill and decode over a mesh, in
    one process: the parameters are ``repro``'s stacked keys as
    :class:`~repro_torch.sharding.placement.Sharded` tensors, the caches a
    tree of them in ``cache_spec``'s layout.

    Each data row runs its slice of the batch (its first device holds its
    activations), layer by layer in lockstep with the other rows, so that a
    MoE group that straddles rows can be routed whole
    (``moe.moe_rows``).  Within a row the blocks split over the model axis
    (``blocks.apply_block_rows``); a layer's weights are read a row at a
    time (``Sharded.split``), so under FSDP they are gathered inside the
    layer, and again in its recomputation under remat.  The embedding looks
    tokens up in each device's vocab range and sums the results; the head
    concatenates the devices' logits before the final softcap.  The loss is
    formed over the global batch: each row's sum of token log-likelihoods
    over the global count of labelled tokens.
    """

    def __init__(self, model: LanguageModel, mesh):
        self.model = model
        self.cfg = model.cfg
        self.mesh = mesh
        self.rows = [tuple(row) for row in mesh.devices]

    # -- parameters -------------------------------------------------------------

    def layer_params(self, params: dict) -> dict:
        """``{port name: Sharded}`` of a stacked ``{repro key: Sharded}``
        dict, each stack unbound once (``LanguageModel.unstack``)."""
        unbound, out = {}, {}
        for name, (key, row) in self.model.reference_names().items():
            if row is None:
                out[name] = params[key]
                continue
            if key not in unbound:
                unbound[key] = params[key].unbind()
            out[name] = unbound[key][row]
        return out

    def _batch_rows(self, batch: dict) -> list:
        """Each row's slice of a global batch, on its first device."""
        n = next(iter(batch.values())).shape[0]
        return [{k: v[sl].to(row[0]) for k, v in batch.items()}
                for sl, row in zip(_row_slices(n, len(self.rows)), self.rows)]

    # -- embedding / head --------------------------------------------------------

    def _embed(self, pp, tokens, r: int):
        return _embed(self.cfg, pp["embed/tokens"].split(r), tokens)

    def _head(self, pp, x, r: int):
        key = "embed/tokens" if self.cfg.tie_embeddings else "unembed"
        return _head(self.cfg, x, pp["final_norm"].split(r).full(),
                     pp[key].split(r))

    def _contexts(self, pp, rows_batch: list, seq_len: int,
                  stats=None) -> list:
        cfg = self.cfg
        ctxs = [{"positions": _positions(b["tokens"], seq_len),
                 "kv_src": b.get("images") if cfg.family == "vlm" else None,
                 "stats": stats}
                for b in rows_batch]
        if cfg.family == "audio":
            enc = [_enc_input(pp["enc_pos"].split(r).full(), b["frames"])
                   for r, b in enumerate(rows_batch)]
            xs, _ = self._run_groups(pp, [e[0] for e in enc],
                                     [e[1] for e in enc], _enc_pattern(cfg),
                                     "enc")
            for r, x in enumerate(xs):
                ctxs[r]["kv_src"] = common.rms_norm(
                    x, pp["enc_final_norm"].split(r).full(), cfg.norm_eps)
        return ctxs

    # -- layers ------------------------------------------------------------------

    def _run_groups(self, pp, xs, ctxs, pattern, scope, sink=None):
        return self.model._run_groups(pp, xs, ctxs, pattern, scope, sink,
                                      layer_fn=self._layer,
                                      device=xs[0].device)

    def _layer(self, layer, kinds, xs, ctxs, sink=None, gi=0, li=0):
        aux_total = torch.zeros((), dtype=torch.float32, device=xs[0].device)
        for bi, kind in enumerate(kinds):
            bkey = f"b{bi}:{kind}"
            ps = [{path: sh.split(r) for path, sh in layer[bkey].items()}
                  for r in range(len(self.rows))]
            xs, aux, kvs = blocks.apply_block_rows(self.cfg, kind, ps, xs,
                                                   ctxs, self.rows)
            aux_total = aux_total + aux.to(aux_total.device)
            if sink is not None:
                sink(gi, li, bkey, kind, kvs)
        return list(xs), aux_total

    # -- training loss -------------------------------------------------------------

    def loss(self, params: dict, batch: dict):
        """``LanguageModel.loss`` of the global ``batch`` (its rows split
        over the data axis, which must divide them)."""
        n = batch["tokens"].shape[0]
        if n % len(self.rows):
            raise ValueError(f"a batch of {n} rows does not split over a "
                             f"data axis of {len(self.rows)}")
        pp = self.layer_params(params)
        rows_batch = self._batch_rows(batch)
        xs = [self._embed(pp, b["tokens"], r)
              for r, b in enumerate(rows_batch)]
        ctxs = self._contexts(pp, rows_batch, batch["tokens"].shape[1])
        xs, aux = self._run_groups(pp, xs, ctxs, self.cfg.pattern, "dec")
        first = self.mesh.first_device
        ll, count = None, None
        for r, (x, b) in enumerate(zip(xs, rows_batch)):
            part, c = _ll_sum(self._head(pp, x, r), b["labels"])
            ll = part.to(first) if ll is None else ll + part.to(first)
            count = c.to(first) if count is None else count + c.to(first)
        ce = -ll / torch.clamp(count, min=1.0)
        aux = aux.to(first)
        return ce + aux, {"ce": ce, "aux": aux}

    # -- serving -------------------------------------------------------------------

    def _cache_rows(self, caches):
        """``[gi][bkey]`` -> a list per layer of a list per row of the cache
        tree of :class:`Split`s (views of the shards)."""
        def per_leaf(sh: Sharded):
            return _Layers([[layer.split(r, gather_data=False)
                             for r in range(len(self.rows))]
                            for layer in sh.unbind()])

        def pick(tree, li, r):
            if isinstance(tree, _Layers):
                return tree[li][r]
            if isinstance(tree, dict):
                return {k: pick(v, li, r) for k, v in tree.items()}
            return [pick(v, li, r) for v in tree]

        out = []
        for (repeat, _), group in zip(self.cfg.pattern, caches):
            g = {}
            for bkey, tree in group.items():
                leaves = _tree_map(per_leaf, tree)
                g[bkey] = [[pick(leaves, li, r) for r in range(len(self.rows))]
                           for li in range(repeat)]
            out.append(g)
        return out

    @torch.no_grad()
    def prefill(self, params, batch, caches, stats=None):
        """``LanguageModel.prefill`` into ``caches`` (zeroed
        :class:`Sharded` trees of ``smax`` positions).  Returns (last-token
        logits (B, V) on the mesh's first device, caches)."""
        cfg = self.cfg
        s = batch["tokens"].shape[1]
        pp = self.layer_params(params)
        rows_batch = self._batch_rows(batch)
        crows = self._cache_rows(caches)

        def sink(gi, li, bkey, kind, kvs):
            for r, kv in enumerate(kvs):
                blocks.payload_to_split_cache(kind, kv, crows[gi][bkey][li][r],
                                              s)

        xs = [self._embed(pp, b["tokens"], r) for r, b in enumerate(rows_batch)]
        ctxs = self._contexts(pp, rows_batch, s, stats)
        xs, _ = self._run_groups(pp, xs, ctxs, cfg.pattern, "dec", sink)
        return self._logits(pp, [x[:, -1] for x in xs], batch), caches

    def _logits(self, pp, xs, batch):
        first = self.mesh.first_device
        n = next(iter(batch.values())).shape[0]
        logits = [self._head(pp, x, r).to(first) for r, x in enumerate(xs)]
        return logits[0] if n % len(self.rows) else torch.cat(logits)

    @torch.no_grad()
    def decode_step(self, params, caches, token, pos, stats=None):
        """``LanguageModel.decode_step``: token (B,), the caches updated in
        place at ``pos``.  Returns (logits (B, V), caches)."""
        cfg = self.cfg
        pos = int(pos)
        pp = self.layer_params(params)
        rows_tok = self._batch_rows({"token": token})
        crows = self._cache_rows(caches)
        xs = [self._embed(pp, b["token"][:, None], r)
              for r, b in enumerate(rows_tok)]
        ctx = {"pos": pos, "stats": stats}
        for gi, (repeat, kinds) in enumerate(cfg.pattern):
            for li in range(repeat):
                layer = self.model._layer_params(pp, "dec", gi, li)
                for bi, kind in enumerate(kinds):
                    bkey = f"b{bi}:{kind}"
                    ps = [{path: sh.split(r) for path, sh in
                           layer[bkey].items()} for r in range(len(self.rows))]
                    xs = blocks.decode_block_rows(cfg, kind, ps, xs,
                                                  crows[gi][bkey][li], ctx,
                                                  self.rows)
        return self._logits(pp, [x[:, 0] for x in xs], {"token": token}), caches
