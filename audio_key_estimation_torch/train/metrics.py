"""Evaluation metrics: MIREX weighted key score and accuracies.

The port of the JAX package's train/metrics.py on torch tensors of any
leading shape, with the reference's quirks kept exactly:
 * prediction = KEY_SIGNATURE_MAP row with max cosine similarity to the
   12-dim sigmoid output (models.py:1083-1085);
 * "fifths" compares the predicted row index (circle-of-fifths order, 21
   rows) against argmax of the 24-slot `key_signature_id` one-hot
   (chromatic loader order) with |diff| == 1 (models.py:1095,1100); an
   all-zero key_signature_id argmaxes to 0;
 * category precedence: fifths is tested first and excludes correct
   (models.py:1100-1113);
 * mirex = correct + 0.5*fifths + 0.3*relative + 0.2*parallel
   (models.py:1114).
"""

from __future__ import annotations

import torch

from ..utils.key_signatures import KEY_SIGNATURE_MAP


def _cosine(a, b, dim=-1, eps=1e-8):
    num = torch.sum(a * b, dim=dim)
    den = torch.linalg.norm(a, dim=dim) * torch.linalg.norm(b, dim=dim)
    return num / torch.clamp(den, min=eps)


def mirex_categories(key_labels, key_preds, tonic_labels, tonic_preds,
                     key_signature_id):
    """Per-sample MIREX category indicators (models.py:1065-1113).

    Inputs (..., 12/24) with any leading shape. Returns a dict of float32
    tensors with that leading shape: correct, fifths, relative, parallel,
    other, accuracy, plus the per-sample 'mirex' contribution.
    """
    ksm = torch.as_tensor(KEY_SIGNATURE_MAP, dtype=key_preds.dtype,
                          device=key_preds.device)               # (21, 12)
    sims = _cosine(key_preds[..., None, :], ksm)                 # (..., 21)
    pred_key_id = torch.argmax(sims, dim=-1)
    key_pred_rows = ksm[pred_key_id]
    key_sig_label_id = torch.argmax(key_signature_id, dim=-1)

    exact = torch.sum(key_pred_rows == key_labels, dim=-1) == 12
    correct_tonic = (torch.argmax(tonic_labels, dim=-1)
                     == torch.argmax(tonic_preds, dim=-1))
    diff = torch.abs(pred_key_id - key_sig_label_id)

    fifths = (diff == 1) & ~(correct_tonic & exact)
    correct = correct_tonic & exact & ~fifths
    relative = exact & ~correct_tonic & ~fifths & ~correct
    parallel = correct_tonic & ~exact & ~fifths & ~correct & ~relative
    other = ~(fifths | correct | relative | parallel)
    out = {k: v.float() for k, v in dict(
        correct=correct, fifths=fifths, relative=relative, parallel=parallel,
        other=other, accuracy=exact).items()}
    out["mirex"] = (out["correct"] + 0.5 * out["fifths"]
                    + 0.3 * out["relative"] + 0.2 * out["parallel"])
    return out


def mirex_score(key_labels, key_preds, tonic_labels, tonic_preds,
                key_signature_id):
    """Batch-averaged MIREX breakdown (models.py:1065-1116)."""
    cats = mirex_categories(key_labels, key_preds, tonic_labels, tonic_preds,
                            key_signature_id)
    return {k: torch.mean(v) for k, v in cats.items()}


def all_key_accuracy(key_labels, key_preds):
    """Exact-match accuracy after top-7 binarization (models.py:1029-1039).

    A prediction binarizes to (value >= 7th-largest value); ties therefore
    can mark more than 7 classes, as in the reference.
    """
    thresh = torch.sort(key_preds, dim=1).values[:, -7][:, None]
    binarized = (key_preds >= thresh).to(key_labels.dtype)
    exact = torch.sum(binarized == key_labels, dim=1) == 12
    return torch.mean(exact.float())


def tonic_accuracy(tonic_labels_idx, tonic_preds):
    return torch.mean((torch.argmax(tonic_preds, dim=1)
                       == tonic_labels_idx).float())


def genre_accuracy(genre_labels_idx, genre_preds, genre_mask):
    """Accuracy over samples that carry a genre label (models.py:916-923).

    Returns 0.0 when no sample in the batch is labeled, like the reference.
    """
    hits = (torch.argmax(genre_preds, dim=1) == genre_labels_idx) & genre_mask
    cnt = torch.sum(genre_mask)
    return torch.where(cnt == 0, 0.0, torch.sum(hits) / torch.clamp(cnt,
                                                                   min=1))
