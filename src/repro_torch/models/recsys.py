"""MIND multi-interest recsys model [1904.08030] (torch port).

The port of ``repro.models.recsys``:

  * **EmbeddingBag**: the ragged form (``indices`` + ``offsets``, the
    torch.nn.EmbeddingBag layout) and the fixed-shape form (ids + mask)
    that the model uses.  Both are torch ops (gather, masked sum), as the
    JAX package's are ``jnp.take`` and sums; the ``embedding_bag`` CUDA
    kernel (``kernels/embedding_bag.py``) is the port of the Pallas bag,
    which the model does not call.
  * **Capsule multi-interest extractor**: behaviour-to-interest dynamic
    routing, ``capsule_iters`` rounds from a fixed ``sin`` routing-logit
    init, softmax over the K interests with masked history slots at -1e30,
    the squash nonlinearity.
  * **Label-aware attention**, **serve scoring** (users x their candidate
    lists) and **retrieval scoring** (users x the whole candidate corpus):
    the max over interests of dot products.
  * **Training loss** (:func:`loss_fn`): label-aware attention against the
    target item, then a sampled softmax with in-batch negatives.

Parameters are the JAX package's names and layout; :func:`load_jax_params`
carries a JAX parameter tree across.  They are trainable; the two scoring
entry points run under ``torch.no_grad()`` (JAX never differentiates them).

On a mesh (``par``, a :class:`~repro_torch.models.parallel.MeshParallel`,
the parameters DTensors placed by :func:`param_specs`) the embedding
tables are row-split over "model" and looked up as the LM embedding is:
each rank gathers the ids in its row range, the rows summed over "model";
the users are this rank's rows (split over the data axes), the dense
layers whole; the retrieval corpus is split over every axis, each rank
scoring its chunk of candidates; the training loss's in-batch negatives
are the global batch's targets (gathered over the data axes).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch.distributed.tensor import DTensor, Partial, Shard

from repro_torch.models.parallel import P, local
from repro_torch.models.transformer import _MeshModule, bind_param, model_device


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    n_items: int = 100_000
    n_user_feats: int = 10_000
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    user_feat_len: int = 8
    d_hidden: int = 128
    dtype: Any = torch.float32

    def validate(self) -> None:
        if self.n_interests < 1 or self.capsule_iters < 1:
            raise ValueError(f"n_interests {self.n_interests} and capsule_iters "
                             f"{self.capsule_iters} must be >= 1")


# ---------------------------------------------------------------------------
# EmbeddingBag
# ---------------------------------------------------------------------------
def embedding_bag(table: torch.Tensor, indices: torch.Tensor, offsets: torch.Tensor,
                  mode: str = "mean") -> torch.Tensor:
    """Ragged EmbeddingBag: pool ``table[indices]`` into per-bag vectors.

    indices: int [nnz] flattened bag contents; offsets: int [n_bags] start
    of each bag (ascending, the last bag runs to nnz).  Positions before
    the first offset belong to no bag; an empty bag pools to 0."""
    nnz, n_bags = indices.shape[0], offsets.shape[0]
    rows = table[indices.long()]
    pos = torch.arange(nnz, device=table.device, dtype=offsets.dtype)
    bag = torch.searchsorted(offsets, pos, right=True) - 1
    inside = bag >= 0
    bag, rows = bag[inside], rows[inside]
    out = table.new_zeros((n_bags, table.shape[1])).index_add_(0, bag, rows)
    if mode == "mean":
        cnt = torch.zeros(n_bags, dtype=torch.float32, device=table.device)
        cnt.index_add_(0, bag, torch.ones(bag.shape[0], device=table.device))
        out = out / cnt.clamp_min(1.0)[:, None]
    return out


def embedding_bag_dense(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                        mode: str = "mean") -> torch.Tensor:
    """Fixed-shape bag: ids [B, L], mask [B, L] -> [B, d]; negative ids
    read row 0 (their mask should be False)."""
    return pool_rows(table[ids.clamp_min(0).long()], mask, mode)


def pool_rows(rows: torch.Tensor, mask: torch.Tensor, mode: str = "mean") -> torch.Tensor:
    """The bag of looked-up rows [B, L, d] under mask [B, L] -> [B, d]."""
    m = mask.to(rows.dtype)[..., None]
    s = (rows * m).sum(dim=1)
    if mode == "mean":
        s = s / m.sum(dim=1).clamp_min(1.0)
    return s


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def shapes(cfg: MINDConfig) -> dict[str, tuple[int, ...]]:
    d = cfg.embed_dim
    return {
        "item_embed": (cfg.n_items, d),
        "user_embed": (cfg.n_user_feats, d),
        "bilinear": (d, d),
        "w_hidden": (2 * d, cfg.d_hidden),
        "b_hidden": (cfg.d_hidden,),
        "w_out": (cfg.d_hidden, d),
        "b_out": (d,),
    }


def param_specs(cfg: MINDConfig, tp="model") -> dict:
    """The JAX ``param_specs``: the embedding tables row-split over ``tp``
    (the canonical recsys placement), the small dense layers whole."""
    del cfg
    return {"item_embed": P(tp, None), "user_embed": P(tp, None), "bilinear": P(None, None),
            "w_hidden": P(None, None), "b_hidden": P(None), "w_out": P(None, None),
            "b_out": P(None)}


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Random init as the JAX ``init``: ``b_*`` zeros, the embedding tables
    normal * 0.1, every other weight normal * 1/sqrt(shape[0]).  Drawn in
    place (a 2^26 x 64 table has no room for a second copy on one card);
    the draws differ from JAX's."""
    for name, p in model.named_parameters():
        if name.startswith("b_"):
            p.zero_()
        else:
            std = 0.1 if "embed" in name else 1.0 / math.sqrt(p.shape[0])
            p.normal_(0.0, std, generator=generator)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------
def squash(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    n2 = (x * x).sum(dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * x / torch.sqrt(n2 + 1e-9)


def multi_interest(bilinear: torch.Tensor, behav_emb: torch.Tensor, mask: torch.Tensor,
                   cfg: MINDConfig) -> torch.Tensor:
    """B2I dynamic routing.  behav_emb [B, H, d], mask [B, H] -> [B, K, d]."""
    B, H, _ = behav_emb.shape
    K = cfg.n_interests
    e_hat = behav_emb @ bilinear                                    # [B, H, d]
    # fixed (non-trainable, deterministic) routing-logit init as in MIND
    binit = torch.sin(torch.arange(K * H, dtype=torch.float32, device=e_hat.device) * 12.9898)
    b = binit.reshape(1, K, H).expand(B, K, H)
    neg = ~mask.bool()[:, None, :]
    u = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(torch.where(neg, -1e30, b), dim=1)       # over K
        u = squash(torch.einsum("bkh,bhd->bkd", w, e_hat))
        b = b + torch.einsum("bkd,bhd->bkh", u, e_hat)
    return u


def label_aware_attention(interests: torch.Tensor, target_emb: torch.Tensor,
                          p: float = 2.0) -> torch.Tensor:
    """MIND label-aware attention: pow-softmax over interests."""
    s = torch.einsum("bkd,bd->bk", interests, target_emb)
    w = torch.softmax((s.abs() + 1e-9) ** p * torch.sign(s), dim=-1)
    return torch.einsum("bk,bkd->bd", w, interests)


class MIND(_MeshModule):
    """The MIND model.  ``device`` defaults to CUDA and raises without a
    card unless ``"cpu"`` is asked for; ``generator`` (on that device)
    draws the random init, a generator seeded 0 when None.

    A batch is a dict in the layout of ``repro.configs.recsys_family``:
    ``hist`` int [B, hist_len], ``hist_mask`` bool [B, hist_len],
    ``user_feats`` int [B, user_feat_len], and ``candidates`` int [B, C]
    (serve) or ``candidate_ids`` int [N] (retrieval).

    ``device="meta"`` builds the shapes only (:func:`init_abstract`);
    ``params`` (keyed as :func:`shapes`) binds the model to those tensors,
    unchanged, as ``Transformer(params=...)`` does; with ``par`` they are
    DTensors placed by :func:`param_specs` and the model runs on that mesh
    (the module docstring), a batch's leaves this rank's rows (local
    tensors or DTensors)."""

    def __init__(self, cfg: MINDConfig, device=None,
                 generator: torch.Generator | None = None, params: dict | None = None,
                 par=None):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.par = par
        if par is not None and params is None:
            raise ValueError("a mesh model is bound to placed parameters (params=)")
        if params is not None:
            if set(params) != set(shapes(cfg)):
                raise ValueError(f"params {sorted(params)}, the config's {sorted(shapes(cfg))}")
            for name, shape in shapes(cfg).items():
                self.register_parameter(name, bind_param(params, name, shape, cfg.dtype))
            return
        dev = model_device(device)
        for name, shape in shapes(cfg).items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=cfg.dtype, device=dev)))
        if dev.type == "meta":
            return
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        init_params(self, generator)

    def lookup(self, name: str, ids: torch.Tensor) -> torch.Tensor:
        """Rows of table ``name`` at ``ids`` (int, any shape; the same on
        every rank of "model"); on a mesh with the table row-split, each
        rank gathers the ids in its range and the rows are summed over
        "model" (every other rank adds zeros: exact)."""
        ids = ids.long()
        if not self.split(name):
            return self.w(name)[ids]
        lo, hi = self.par.model_range(getattr(self, name).shape[0])
        inside = (ids >= lo) & (ids < hi)
        rows = self.w(name)[(ids - lo).clamp(0, max(hi - lo - 1, 0))]
        return self.exit(rows * inside[..., None].to(rows.dtype))

    def user_tower(self, batch: dict) -> torch.Tensor:
        """-> interests [B, K, d] (profile-feature conditioned)."""
        cfg = self.cfg
        mask = local(batch["hist_mask"])
        behav = self.lookup("item_embed", local(batch["hist"]).clamp_min(0))
        behav = behav * mask[..., None].to(behav.dtype)
        interests = multi_interest(self.w("bilinear"), behav, mask, cfg)
        feats = local(batch["user_feats"])
        profile = pool_rows(self.lookup("user_embed", feats.clamp_min(0)),
                            torch.ones_like(feats), "mean")
        B, K, d = interests.shape
        h = torch.cat([interests, profile[:, None].expand(B, K, d)], dim=-1)
        h = torch.relu(h @ self.w("w_hidden") + self.w("b_hidden"))
        return h @ self.w("w_out") + self.w("b_out")

    @torch.no_grad()
    def serve_score(self, batch: dict) -> torch.Tensor:
        """Online scoring: scores [B, C], each the max over interests of the
        candidate's dot products (on a mesh this rank's rows)."""
        interests = self.user_tower(batch)                              # [B, K, d]
        cand = self.lookup("item_embed", local(batch["candidates"]))    # [B, C, d]
        return torch.einsum("bkd,bcd->bkc", interests, cand).amax(dim=1)

    @torch.no_grad()
    def retrieval_score(self, batch: dict) -> torch.Tensor:
        """Retrieval: the users against the candidate corpus ``candidate_ids``
        [N] in one batched product -> scores [B, N].  On a mesh with the
        corpus split over "model" (a DTensor), this rank's chunk: the ids
        of its "model" group gathered, their rows looked up split and
        reduce-scattered over "model", scores [B, N_local]."""
        interests = self.user_tower(batch)                              # [B, K, d]
        ids = batch["candidate_ids"]
        par = self.par
        if par is not None and par.tp > 1 and isinstance(ids, DTensor) and \
                ids.placements[-1].is_shard():
            mine = local(ids).long()
            if self.split("item_embed"):
                group = par.gather_model(mine, 0, mine.shape[0] * par.tp)
                table = self.w("item_embed")
                lo, hi = par.model_range(getattr(self, "item_embed").shape[0])
                inside = (group >= lo) & (group < hi)
                part = table[(group - lo).clamp(0, max(hi - lo - 1, 0))] \
                    * inside[:, None].to(table.dtype)
                # the lookup's sum over "model" as a reduce-scatter: each
                # rank keeps the rows of its own chunk (zeros added: exact)
                cand = DTensor.from_local(part, par.model, [Partial()], run_check=False
                                          ).redistribute(par.model, [Shard(0)]).to_local()
            else:
                cand = self.w("item_embed")[mine]
        else:
            cand = self.lookup("item_embed", local(ids))                # [N, d]
        return torch.einsum("bkd,nd->bkn", interests, cand).amax(dim=1)


def init_abstract(cfg: MINDConfig) -> dict:
    """The parameters as ``meta`` tensors keyed as :func:`shapes` (the JAX
    ``init_abstract``): shapes and dtypes, nothing allocated."""
    return dict(MIND(cfg, device="meta").named_parameters())


def loss_fn(model: MIND, batch: dict) -> torch.Tensor:
    """Sampled softmax with in-batch negatives (the JAX ``loss_fn``): each
    user's label-aware vector against every target of the batch ``target``
    int [B], the user's own target the gold class.

    The mean of logsumexp - gold is taken by ``F.cross_entropy`` (the same
    function): its fused log-softmax backward writes the [B, B] gradient
    in one pass, where autograd of logsumexp minus a gather materialises
    the difference, its exponential and the gather's scattered gradient
    as separate [B, B] buffers, 17 GB each at ``train_batch`` (B = 65,536),
    whose step peaks at 68 GB on an 80 GB card with this form."""
    interests = model.user_tower(batch)                          # [B, K, d]
    tgt = model.lookup("item_embed", local(batch["target"]))     # [B, d]
    user_vec = label_aware_attention(interests, tgt)             # [B, d]
    par = model.par
    if par is None or par.dp == 1 or not par.batch_split:
        logits = user_vec @ tgt.T                                # [B, B] in-batch
        return F.cross_entropy(logits, torch.arange(logits.shape[0], device=logits.device))
    # on a mesh: this rank's users against the global batch's targets; the
    # result is this rank's share of the mean (summed over the data axes)
    b = tgt.shape[0]
    logits = user_vec @ par.gather_rows(tgt).T                   # [b, B]
    gold = par.dp_rank * b + torch.arange(b, device=logits.device)
    return F.cross_entropy(logits, gold, reduction="sum") / (b * par.dp)


@torch.no_grad()
def load_jax_params(model: MIND, params: dict) -> None:
    """Load a JAX parameter tree (numpy leaves, e.g.
    ``jax.tree.map(np.asarray, repro.models.recsys.init(cfg, key))``)."""
    want = shapes(model.cfg)
    got = {k: tuple(np.shape(v)) for k, v in params.items()}
    if got != want:
        raise ValueError(f"parameter tree {got} does not match the config's {want}")
    for name, value in params.items():
        getattr(model, name).copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
