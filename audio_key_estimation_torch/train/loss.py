"""Multi-task loss (reference models.py:854-896), the port of the JAX
package's train/loss.py on torch tensors.

loss = key_weight * BCE(key_sigmoid, key_multihot)
     + tonic_weight * CE(tonic_logits, tonic_idx)
     [+ genre_weight * CE(genre_logits[mask], genre_idx[mask]) if any labeled]
     [+ (1 - mean cosine(key_sigmoid, key_multihot)) if use_cos]

The BCE is the JAX formula on the sigmoid clipped to [1e-7, 1 - 1e-7],
not F.binary_cross_entropy (which clamps the log at -100 instead). Local
(per-window) mode averages per-sample masked window losses
(models.py:861-876); the genre mask drops samples with missing labels
(rows that don't sum to 1, models.py:839).
"""

from __future__ import annotations

import torch

from ..config import Config


def _bce(pred_sigmoid, target, eps=1e-7):
    p = torch.clamp(pred_sigmoid, eps, 1 - eps)
    return -(target * torch.log(p) + (1 - target) * torch.log(1 - p))


def _cross_entropy(logits, labels_idx):
    """Softmax cross entropy with integer labels over the last axis
    (optax.softmax_cross_entropy_with_integer_labels)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels_idx[..., None])[..., 0]


def _wmean(x, w):
    """Mean of per-sample values x (N,), weighted by optional 0/1 w (N,)."""
    if w is None:
        return torch.mean(x)
    w = w.to(x.dtype)
    return torch.sum(w * x) / torch.clamp(torch.sum(w), min=1)


def _masked_sum(frames, wmask):
    """sum(wmask * frames) over the window axis, with masked (weight-0)
    positions contributing exactly 0 even when frames is inf/NaN there —
    padded windows see zero-padded inputs, and 0 * inf = NaN would
    otherwise poison the whole batch."""
    return torch.where(wmask > 0, wmask * frames, 0.0).sum(-1)


def _per_sample(cfg: Config, outputs, batch, train: bool) -> dict:
    """Each loss term per sample (N,): bce, tonic, genre (with its 0/1
    genre_mask, rows whose genre sums to 1) and cos, as present."""
    if cfg.genre:
        key_out, tonic_out, genre_out = outputs
    else:
        key_out, tonic_out = outputs
        genre_out = None

    key_labels = batch["key_labels"].to(key_out.dtype)
    tonic_labels = batch["tonic_labels"]
    terms = {}

    if cfg.local:
        # per-frame losses masked to each sample's valid window count
        # (models.py:864-876): valid = seq_len - (loc_window*frames) + 1
        valid = batch["seq_length"] - cfg.loc_window_size * cfg.frames + 1
        valid = torch.clamp(valid, min=0)
        t = key_out.shape[1]
        wmask = (torch.arange(t, device=key_out.device)[None, :]
                 < valid[:, None]).to(key_out.dtype)              # (N, T)
        if (train and cfg.straddle_weight != 1.0
                and "window_coverage" in batch):
            # down-weight (or mask, at 0.0) windows whose label segment
            # does not cover their full audio span; the weighted mean
            # renormalizes by the surviving weight, and a sample with no
            # surviving windows contributes 0
            cov = batch["window_coverage"][:, :t]
            wmask = wmask * torch.where(cov >= 1.0, 1.0, cfg.straddle_weight)
            denom = torch.clamp(torch.sum(wmask, dim=-1),
                                min=1.0).to(key_out.dtype)
        else:
            denom = torch.clamp(valid, min=1).to(key_out.dtype)
        bce_frames = _bce(key_out, key_labels).mean(-1)           # (N, T)
        terms["bce"] = _masked_sum(bce_frames, wmask) / denom
        tonic_idx = torch.argmax(tonic_labels, dim=2)
        ce_frames = _cross_entropy(tonic_out, tonic_idx)          # (N, T)
        terms["tonic"] = _masked_sum(ce_frames, wmask) / denom
    else:
        terms["bce"] = _bce(key_out, key_labels).mean(-1)
        tonic_idx = torch.argmax(tonic_labels, dim=1)
        terms["tonic"] = _cross_entropy(tonic_out, tonic_idx)

    if cfg.genre and genre_out is not None:
        genre_labels = batch["genre"]                             # (N, 11)
        terms["genre_mask"] = torch.sum(genre_labels, dim=1) == 1  # (N,)
        genre_idx = torch.argmax(genre_labels, dim=1)
        if cfg.local:
            # genre is constant per song: masked per-window CE averaged
            # per sample, then over labeled samples; the genre head has no
            # sliding-window max, so its time axis is longer than the key
            # head's: score its first T windows
            g = genre_out[:, :t]
            ce_frames = _cross_entropy(
                g, genre_idx[:, None].expand(g.shape[:2]))        # (N, T)
            terms["genre"] = _masked_sum(ce_frames, wmask) / denom  # (N,)
        else:
            terms["genre"] = _cross_entropy(genre_out, genre_idx)  # (N,)

    if cfg.use_cos:
        num = torch.sum(key_out * key_labels, dim=-1)
        den = torch.clamp(torch.linalg.norm(key_out, dim=-1)
                          * torch.linalg.norm(key_labels, dim=-1), min=1e-8)
        cos = num / den
        if cfg.local:
            # per-window cosine over the 12 key dims, averaged over each
            # sample's valid windows (the JAX package's intended masked
            # per-window semantics, not the reference's time-axis cosine)
            cos = _masked_sum(cos, wmask) / denom
        terms["cos"] = cos
    return terms


def _genre_weights(terms: dict, sample_weights):
    gw = terms["genre_mask"].to(terms["genre"].dtype)
    if sample_weights is not None:
        gw = gw * sample_weights.to(gw.dtype)
    return gw


def compute_loss(cfg: Config, outputs, batch, sample_weights=None,
                 train=True):
    """Returns (loss, aux) for one batch.

    outputs: (key, tonic[, genre]) from the model.
    batch: dict of tensors with key_labels, tonic_labels, (genre,) and in
    local mode seq_length (true frame counts) and optionally
    window_coverage.

    sample_weights: optional (N,) 0/1 weights. The eval path passes the
    batch's `valid` mask so repeat-padded duplicate rows (dataset.batches
    pads the tail batch by repeating its last sample) do not bias the
    reported loss. None (the train path, where every row is real) keeps
    plain means.

    train: straddle down-weighting (cfg.straddle_weight, local mode) is a
    TRAINING-loss treatment only; eval passes train=False so val_loss — the
    early-stopping monitor — scores every valid window.
    """
    terms = _per_sample(cfg, outputs, batch, train)
    aux = {}
    bce_loss = _wmean(terms["bce"], sample_weights)
    tonic_loss = _wmean(terms["tonic"], sample_weights)
    loss = cfg.key_weight * bce_loss + cfg.tonic_weight * tonic_loss
    aux["bce_loss"] = bce_loss
    aux["tonic_loss"] = tonic_loss

    if "genre" in terms:
        ce = terms["genre"]
        gw = _genre_weights(terms, sample_weights)
        cnt = torch.sum(gw)
        genre_loss = torch.where(cnt == 0, 0.0,
                                 torch.sum(gw * ce) / torch.clamp(cnt, min=1))
        loss = loss + cfg.genre_weight * genre_loss
        aux["genre_loss"] = genre_loss
        aux["genre_mask_count"] = cnt

    if "cos" in terms:
        cos_mean = _wmean(terms["cos"], sample_weights)
        loss = loss + (1 - cos_mean)
        aux["cos_sim"] = cos_mean

    aux["loss"] = loss
    return loss, aux


# ---------------------------------------------------------------------------
# data parallelism: one rank's share of a global batch's loss
# ---------------------------------------------------------------------------
# compute_loss divides two batch-wide sums: each mean by the batch's
# sample count (or the sum of sample_weights), the genre term by its
# genre-labelled count. Over ranks that each hold some rows of one global
# batch, the loss is each rank's sums over the GLOBAL counts: the counts
# depend on the labels only, so they are all-reduced before the forward
# and carry no gradient, and the ranks' shares add up to compute_loss of
# the whole batch. A per-rank mean averaged over ranks differs whenever
# the shards differ in genre-labelled rows or sample weights.

def loss_totals(cfg: Config, batch, sample_weights=None) -> torch.Tensor:
    """(2,) float32 [sample count or sum of sample_weights,
    genre-labelled count] of this rank's rows: sum them over the ranks
    for loss_share's `totals`."""
    dev = batch["key_labels"].device
    n = (torch.tensor(float(batch["key_labels"].shape[0]), device=dev)
         if sample_weights is None else sample_weights.float().sum())
    cnt = torch.zeros((), device=dev)
    if cfg.genre:
        gw = (torch.sum(batch["genre"], dim=1) == 1).float()
        if sample_weights is not None:
            gw = gw * sample_weights.float()
        cnt = gw.sum()
    return torch.stack([n, cnt])


def loss_sums(cfg: Config, outputs, batch, sample_weights=None,
              train=True) -> torch.Tensor:
    """(2,) [the weighted sum over this rank's rows of every term that
    divides by the sample count (key_weight * bce + tonic_weight * tonic
    + (1 - cos)), the genre-weighted sum of the genre term]."""
    terms = _per_sample(cfg, outputs, batch, train)
    w = 1.0 if sample_weights is None else sample_weights.to(
        terms["bce"].dtype)
    per_n = cfg.key_weight * terms["bce"] + cfg.tonic_weight * terms["tonic"]
    if "cos" in terms:
        per_n = per_n + (1 - terms["cos"])
    genre = torch.zeros((), dtype=per_n.dtype, device=per_n.device)
    if "genre" in terms:
        genre = torch.sum(_genre_weights(terms, sample_weights)
                          * terms["genre"])
    return torch.stack([torch.sum(w * per_n), genre])


def loss_from_sums(cfg: Config, sums: torch.Tensor,
                   totals: torch.Tensor) -> torch.Tensor:
    """compute_loss's combination of loss_sums over loss_totals: with one
    rank's sums and the global totals, that rank's share of the global
    batch's loss (the shares add up to it); with sums and totals both
    summed over ranks, the loss itself."""
    loss = sums[0] / torch.clamp(totals[0], min=1)
    if cfg.genre:
        loss = loss + cfg.genre_weight * torch.where(
            totals[1] == 0, 0.0, sums[1] / torch.clamp(totals[1], min=1))
    return loss


def loss_share(cfg: Config, outputs, batch, totals: torch.Tensor,
               sample_weights=None, train=True) -> torch.Tensor:
    """This rank's share of the global batch's compute_loss, `totals`
    the global loss_totals."""
    return loss_from_sums(cfg, loss_sums(cfg, outputs, batch,
                                         sample_weights, train), totals)
