"""Training and evaluation steps (`feature_point_cnn_tpu/train/steps.py`).

One step holds what the JAX step holds: label encoding and, for the
SuperPoint phase, homographic augmentation on the device; the two views
concatenated into ONE forward of ``2B`` images, so train-mode BatchNorm
statistics pool both; bf16 compute with float32 master parameters and
losses.

Where the JAX steps are pure functions of a state pytree, these update the
`TrainState`'s module and optimizer **in place** and return the same state
object with the metrics.  Metrics are 0-d tensors on the device: nothing
here reads a value back, so steps queue up asynchronously.  Random draws
come from the one `torch.Generator` a step is given, in a fixed order.

`superpoint_train_step` is `_augment_and_encode` followed by
`superpoint_train_step_encoded`, which can be called on given ``(images,
warped, labels, wlabels, cell_mask, homog)``.

Data parallelism (`parallel/`): under a data group each rank passes its
rows of the global batch, and the d ranks compute what one process computes
on the global batch, as the JAX step does over a sharded batch.  Every
random draw is made for the GLOBAL batch from the step's generator, and the
rank keeps its rows; train-mode BatchNorm and every loss divisor count the
global batch (`models/blocks.py`, `train/loss.py`); ONE all-reduce sums the
gradient after the backward and before the clip and the update, so every
rank applies the same update and the parameters stay bit-identical; the
metrics are group-wide.  Microbatch ``i`` of the global batch (items ``i,
i + k, ...``) is the union of the ranks' local microbatches ``i`` only when
each rank's row count divides by k, so the step raises otherwise.

Width sharding (`parallel/spatial.py`): inside ``with
spatial.width_group(mesh.group)`` the d ranks compute JAX's step on a
W-sharded batch.  ``batch["image"]`` is this rank's block of columns
(`mesh.shard_images_spatial`); ``points`` and ``points_valid`` are whole.
Where a step augments or labels, it gathers the prepared image whole once
(exact), makes every draw for the whole image in the one-process order,
builds the labels, the cell mask and the warped view whole, and keeps its
own columns (`superpoint_train_step_encoded` takes whole-width data and
keeps its columns), so the model's input blocks and targets are the
one-process step's columns bit for bit.  Train-mode BatchNorm, the loss
divisors, the gradient sum and the metrics then run over the width group
(`collectives.group` returns it); the descriptor loss splits the items
over the ranks (`train/loss.py`); the F1 is each sample's correct cells
over its whole image.  Every rank holds the whole batch, so microbatch
``i`` is the same items on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

from feature_point_cnn_tpu_torch.config import HomographyConfig, SuperPointConfig
from feature_point_cnn_tpu_torch.data.photometric import photometric_augment_batch
from feature_point_cnn_tpu_torch.device import constant
from feature_point_cnn_tpu_torch.geometry.homography import (
    homographic_augmentation_batch,
    sample_homography_batch,
)
from feature_point_cnn_tpu_torch.models.superpoint import SuperPoint
from feature_point_cnn_tpu_torch.ops.labels import (
    make_points_labels_batch,
    scale_valid_map,
)
from feature_point_cnn_tpu_torch.parallel import spatial
from feature_point_cnn_tpu_torch.parallel.collectives import all_sum_, group, shard
from feature_point_cnn_tpu_torch.train.loss import detector_loss, global_loss
from feature_point_cnn_tpu_torch.train.optimizer import Optimizer
from feature_point_cnn_tpu_torch.utils.metrics import samplewise_f1

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """The module (float32 parameters, BatchNorm statistics), its optimizer
    and the number of steps taken."""

    model: SuperPoint
    optimizer: Optimizer
    step: int = 0


def create_train_state(model: SuperPoint, optimizer: Optimizer) -> TrainState:
    return TrainState(model=model, optimizer=optimizer, step=0)


def _prep_images(images: torch.Tensor, config: SuperPointConfig) -> torch.Tensor:
    """Normalise a batch to ``(B, H, W, image_channels)`` float32 in [0, 1]:
    u8 is scaled by 1/255, a single gray channel repeated."""
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) / 255.0
    if images.shape[-1] == 1 and config.image_channels > 1:
        images = images.expand(*images.shape[:-1], config.image_channels)
    return images


def _grad_norms(model: SuperPoint) -> Dict[str, torch.Tensor]:
    """Per-head global norms of the gradients now in ``.grad`` (a head
    without gradients reads 0)."""
    out = {}
    for head, module in model.named_children():
        grads = [p.grad for p in module.parameters() if p.grad is not None]
        out[f"grad_norm/{head}"] = (
            torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            if grads else torch.zeros((), device=next(module.parameters()).device)
        )
    return out


def _microbatched_backward(
    micro_loss_fn: Callable[[Batch], Tuple[torch.Tensor, object]],
    model: SuperPoint, data: Batch, k: int,
) -> Tuple[torch.Tensor, List[object]]:
    """Split ``data`` into ``k`` microbatches, STRIDED as on the JAX side
    (microbatch ``i`` takes items ``i, i+k, i+2k, ...``), run them in order
    at the same parameters, and leave the gradient of the mean loss in
    ``.grad``.  BatchNorm statistics thread through the microbatches in
    order, since each forward updates the module's buffers.  Peak activation
    memory is that of one microbatch.

    ``micro_loss_fn(micro) -> (loss, aux)``.  Returns ``(mean_loss, [aux of
    each microbatch])``.
    """
    b = next(iter(data.values())).shape[0]
    if b % k != 0:
        n_ranks = shard()[1]
        where = f" on each of {n_ranks} ranks" if n_ranks > 1 else ""
        raise ValueError(
            f"batch size {b}{where} is not divisible by microbatch_steps={k}"
        )
    model.zero_grad(set_to_none=True)
    total, auxes = None, []
    for i in range(k):
        loss, aux = micro_loss_fn({name: v[i::k] for name, v in data.items()})
        (loss / k).backward()
        total = loss.detach() if total is None else total + loss.detach()
        auxes.append(aux)
    _all_sum_grads(model)
    return total / k, auxes


def _all_sum_grads(model: SuperPoint) -> None:
    """Sum the gradients in ``.grad`` over the data or width group, in ONE
    all-reduce of a flat buffer (each rank's are its share of the global
    gradient)."""
    if group() is None:
        return
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = all_sum_(torch.cat([g.reshape(-1) for g in grads]))
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view(g.shape))
        offset += g.numel()


def _global_metrics(shares: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Group-wide metrics from each rank's share of them (the shares sum to
    the global value), in one all-reduce; the identity with no group."""
    if group() is None:
        return shares
    total = all_sum_(torch.stack([v.to(torch.float32) for v in shares.values()]))
    return {k: total[i] for i, k in enumerate(shares)}


def _f1_share(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """This rank's share of the global batch's mean per-sample F1: its rows'
    share under a data group; under a width group its cells' share of each
    sample, over the whole image's cell count (one all-reduce)."""
    if spatial.group() is None:
        return samplewise_f1(logits, labels) / shard()[1]
    correct = (logits.argmax(dim=-1) == labels).to(torch.float32)
    cells = all_sum_(constant((float(correct[0].numel()),), correct.device))[0]
    return correct.reshape(correct.shape[0], -1).sum(dim=-1).mean() / cells


def _interleave(parts: List[torch.Tensor]) -> torch.Tensor:
    """Undo the strided split: microbatch ``i``'s rows go back to ``i::k``.
    (The JAX step concatenates them in microbatch order instead; its F1
    metric pairs them with the unsplit labels.)"""
    k = len(parts)
    if k == 1:
        return parts[0]
    return torch.stack(parts, dim=1).reshape(-1, *parts[0].shape[1:])


# ---------------------------------------------------------------------------
# MagicPoint phase: detector-only on (image, points) batches
# ---------------------------------------------------------------------------

def magicpoint_train_step(
    state: TrainState, batch: Batch, gen: torch.Generator, *,
    config: SuperPointConfig,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """``batch``: ``image (B, H, W, C)`` float or u8, ``points (B, P, 2)``
    ``(y, x)``, ``points_valid (B, P)`` bool, on the model's device.  The
    descriptor head is neither run nor updated (build the optimizer with
    ``frozen_subtree="descriptor"``)."""
    model = state.model.train()
    images, labels = _prep_and_label(batch, gen, config, augment=True)

    def micro_loss(m):
        logits, _ = model.features(m["images"], enable_descriptor=False)
        loss = detector_loss(logits, m["labels"], None, config.cell,
                             config.detector_loss)
        return loss, logits.detach()

    loss, logits_k = _microbatched_backward(
        micro_loss, model, {"images": images, "labels": labels},
        config.microbatch_steps,
    )
    metrics = _global_metrics({
        "loss": loss,
        "detector_loss": loss,
        "f1": _f1_share(_interleave(logits_k), labels),
    })
    metrics.update(_grad_norms(model))
    state.optimizer.step()
    state.step += 1
    return state, metrics


@torch.no_grad()
def magicpoint_eval_step(
    state: TrainState, batch: Batch, gen: torch.Generator, *,
    config: SuperPointConfig,
) -> Dict[str, torch.Tensor]:
    model = state.model.eval()
    images, labels = _prep_and_label(batch, gen, config, augment=False)
    logits, _ = model.features(images, enable_descriptor=False)
    loss = detector_loss(logits, labels, None, config.cell, config.detector_loss)
    return _global_metrics({"loss": loss, "f1": _f1_share(logits, labels)})


def _prep_and_label(batch: Batch, gen: torch.Generator, config: SuperPointConfig,
                    augment: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MagicPoint phase's images (photometric augmentation when
    ``augment`` and the config say so) and labels, each draw made for the
    global batch; under a width group, for the whole image, of which this
    rank keeps its columns."""
    images = _prep_images(batch["image"], config)
    h, w = images.shape[1], images.shape[2] * spatial.split()[1]
    if augment and config.photometric_augment:
        whole = spatial.gather_width(images, 2)
        images = spatial.own_block(photometric_augment_batch(gen, whole, shard=shard()), 2)
    labels = make_points_labels_batch(
        batch["points"], batch["points_valid"], gen, h, w, config.cell,
        shard=shard(),
    )
    return images, spatial.own_block(labels, 2)


# ---------------------------------------------------------------------------
# SuperPoint phase: joint detector + descriptor on augmented pairs
# ---------------------------------------------------------------------------

@torch.no_grad()
def _augment_and_encode(
    batch: Batch, gen: torch.Generator, config: SuperPointConfig,
    homo_config: HomographyConfig,
):
    """-> ``(warped, labels, wlabels, cell_mask (B, Hc, Wc), homog (B, 8),
    images)``.  Draw order: photometric (when on), homographies, label
    noise, warped-label noise.  Under a width group ``batch["image"]`` is
    this rank's block, gathered whole here, and every output is whole."""
    images = spatial.gather_width(_prep_images(batch["image"], config), 2)
    b, h, w = images.shape[:3]
    index, count = part = shard()
    if config.photometric_augment:
        # before the geometric warp, as the reference applies its transforms
        # at dataset-read time
        images = photometric_augment_batch(gen, images, shard=part)
    h_flat = sample_homography_batch(gen, count * b, (h, w), homo_config,
                                     images.device)[index * b:(index + 1) * b]
    warped, wpoints, wvalid, valid_mask, homog = homographic_augmentation_batch(
        None, images, batch["points"], batch["points_valid"], homo_config,
        h_flat=h_flat,
    )
    labels = make_points_labels_batch(
        batch["points"], batch["points_valid"], gen, h, w, config.cell, shard=part
    )
    wlabels = make_points_labels_batch(wpoints, wvalid, gen, h, w, config.cell,
                                       shard=part)
    cell_mask = scale_valid_map(valid_mask, config.cell)
    return warped, labels, wlabels, cell_mask, homog, images


def superpoint_train_step_encoded(
    state: TrainState, data: Batch, *, config: SuperPointConfig,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """The step after augmentation: forward of both views at once, joint
    loss, backward, update.  ``data``: ``images``, ``warped`` ``(B, H, W,
    C)`` float32, ``labels``, ``wlabels`` ``(B, Hc, Wc)`` int64,
    ``cell_mask (B, Hc, Wc)``, ``homog (B, 8)``; whole on every rank of a
    width group, which keeps its columns."""
    model = state.model.train()
    data = _own_columns(data)

    def micro_loss(m):
        mb = m["images"].shape[0]
        both = torch.cat([m["images"], m["warped"]], dim=0)       # (2b, ...)
        logits2, desc2 = model.features(both, enable_descriptor=True)
        losses = global_loss(
            logits2[:mb], m["labels"], logits2[mb:], m["wlabels"],
            desc2[:mb], desc2[mb:], m["homog"], m["cell_mask"], config,
        )
        aux = ({k: v.detach() for k, v in losses.items()}, logits2[:mb].detach())
        return losses["total"], aux

    loss, auxes = _microbatched_backward(
        micro_loss, model, data, config.microbatch_steps
    )
    losses = {k: torch.stack([a[0][k] for a in auxes]).mean()
              for k in auxes[0][0]}
    logits = _interleave([a[1] for a in auxes])
    metrics = _global_metrics({
        "loss": loss,
        "detector_loss": losses["detector"] + losses["warped_detector"],
        "descriptor_loss": losses["descriptor"],
        "f1": _f1_share(logits, data["labels"]),
    })
    metrics.update(_grad_norms(model))
    state.optimizer.step()
    state.step += 1
    return state, metrics


def _own_columns(data: Batch) -> Batch:
    """This rank's columns of whole-width encoded data (``homog`` stays
    whole); the same tensors outside a width group."""
    return {k: v if k == "homog" else spatial.own_block(v, 2) for k, v in data.items()}


def superpoint_train_step(
    state: TrainState, batch: Batch, gen: torch.Generator, *,
    config: SuperPointConfig,
    homo_config: HomographyConfig = HomographyConfig(),
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """``batch`` as for `magicpoint_train_step`."""
    warped, labels, wlabels, cell_mask, homog, images = _augment_and_encode(
        batch, gen, config, homo_config
    )
    data = {
        "images": images, "warped": warped, "labels": labels,
        "wlabels": wlabels, "cell_mask": cell_mask, "homog": homog,
    }
    return superpoint_train_step_encoded(state, data, config=config)


@torch.no_grad()
def superpoint_eval_step(
    state: TrainState, batch: Batch, gen: torch.Generator, *,
    config: SuperPointConfig,
    homo_config: HomographyConfig = HomographyConfig(),
) -> Dict[str, torch.Tensor]:
    model = state.model.eval()
    warped, labels, wlabels, cell_mask, homog, images = _augment_and_encode(
        batch, gen, config, homo_config
    )
    warped, labels, wlabels, cell_mask, images = (
        spatial.own_block(t, 2) for t in (warped, labels, wlabels, cell_mask, images))
    b = images.shape[0]
    logits2, desc2 = model.features(torch.cat([images, warped], dim=0))
    losses = global_loss(
        logits2[:b], labels, logits2[b:], wlabels, desc2[:b], desc2[b:],
        homog, cell_mask, config,
    )
    return _global_metrics({
        "loss": losses["total"],
        "descriptor_loss": losses["descriptor"],
        "f1": _f1_share(logits2[:b], labels),
    })
