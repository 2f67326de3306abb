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
    if cfg.genre:
        key_out, tonic_out, genre_out = outputs
    else:
        key_out, tonic_out = outputs
        genre_out = None

    key_labels = batch["key_labels"].to(key_out.dtype)
    tonic_labels = batch["tonic_labels"]
    aux = {}

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
        bce_loss = _wmean(_masked_sum(bce_frames, wmask) / denom,
                          sample_weights)
        tonic_idx = torch.argmax(tonic_labels, dim=2)
        ce_frames = _cross_entropy(tonic_out, tonic_idx)          # (N, T)
        tonic_loss = _wmean(_masked_sum(ce_frames, wmask) / denom,
                            sample_weights)
    else:
        bce_loss = _wmean(_bce(key_out, key_labels).mean(-1), sample_weights)
        tonic_idx = torch.argmax(tonic_labels, dim=1)
        tonic_loss = _wmean(_cross_entropy(tonic_out, tonic_idx),
                            sample_weights)

    loss = cfg.key_weight * bce_loss + cfg.tonic_weight * tonic_loss
    aux["bce_loss"] = bce_loss
    aux["tonic_loss"] = tonic_loss

    if cfg.genre and genre_out is not None:
        genre_labels = batch["genre"]                             # (N, 11)
        genre_mask = torch.sum(genre_labels, dim=1) == 1          # (N,)
        genre_idx = torch.argmax(genre_labels, dim=1)
        if cfg.local:
            # genre is constant per song: masked per-window CE averaged
            # per sample, then over labeled samples; the genre head has no
            # sliding-window max, so its time axis is longer than the key
            # head's: score its first T windows
            g = genre_out[:, :t]
            ce_frames = _cross_entropy(
                g, genre_idx[:, None].expand(g.shape[:2]))        # (N, T)
            ce = _masked_sum(ce_frames, wmask) / denom            # (N,)
        else:
            ce = _cross_entropy(genre_out, genre_idx)             # (N,)
        gw = genre_mask.to(ce.dtype)
        if sample_weights is not None:
            gw = gw * sample_weights.to(ce.dtype)
        cnt = torch.sum(gw)
        genre_loss = torch.where(cnt == 0, 0.0,
                                 torch.sum(gw * ce) / torch.clamp(cnt, min=1))
        loss = loss + cfg.genre_weight * genre_loss
        aux["genre_loss"] = genre_loss
        aux["genre_mask_count"] = cnt

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
        cos_mean = _wmean(cos, sample_weights)
        loss = loss + (1 - cos_mean)
        aux["cos_sim"] = cos_mean

    aux["loss"] = loss
    return loss, aux
