"""Training loop: train step, evaluation (counterpart of
``pytorch_video_action_tpu/train/loop.py``, reference ``train.py:143-349``).

One train step is the JAX ``Trainer`` step: a ``train=True`` forward with
hash dropout, the model's f32 loss (``make_loss_fn(model.name)``: NLL over
the output, ms_tcn's cross-entropy over logits, ctcloss's CTC against the
collapsed frame labels, ``prepare_ctc_targets``, as the JAX step takes
them), the backward (through the layer kernels on the card), one Adam
update.  Dropout seeds are explicit
uint32 values, ``model.n_dropout_sites`` per step, drawn from a
``torch.Generator`` seeded by ``seed``; ``train_step`` also takes them
from the caller.  Under ``compute_dtype='bfloat16'`` the parameters and
the Adam state stay f32: the forward runs on bf16 copies, so gradients
flow back to the f32 masters through the cast, and the log-softmax and
loss stay f32.  A stateful model (``bilstm_lm``) updates its BatchNorm
running stats, module buffers, in its train forward; the bf16 step casts
only the parameters, so the stats stay f32, as the JAX step passes its
``model_state`` uncast.  Evaluation runs the f32 model in eval form, with
the stored stats, and computes frame accuracy and the per-segment majority
vote.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.func import functional_call

from .. import TARGET_PAD
from ..utils.runlength import run_length_segments
from .losses import make_loss_fn, prepare_ctc_targets
from .optim import make_optimizer, set_lr


@dataclass
class TrainState:
    model: torch.nn.Module  # the f32 master parameters, on the device
    optimizer: torch.optim.Optimizer
    rng: torch.Generator  # draws the dropout seeds
    epoch: int = 0


class Trainer:
    """Owns the train step for one model on one device (``cuda`` unless the
    caller asks for the CPU; a missing card raises)."""

    def __init__(self, model: torch.nn.Module, n_class: int, lr: float = 1e-3,
                 lr_step_size: int = 30, lr_gamma: float = 1.0, seed: int = 0,
                 compute_dtype=None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device is available "
                               "(pass device='cpu' to train on the CPU)")
        self.model = model
        self.n_class = n_class
        self.is_ctc = model.name == "ctcloss"
        self.loss_fn = make_loss_fn(model.name, n_class)
        self.seed = seed
        self.make_opt, self.lr_for_epoch = make_optimizer(
            lr, lr_step_size, lr_gamma)
        if compute_dtype in (None, "float32", torch.float32):
            self.compute_dtype = None
        elif compute_dtype in ("bfloat16", torch.bfloat16):
            self.compute_dtype = torch.bfloat16
        else:
            raise ValueError(f"Trainer: compute_dtype {compute_dtype!r} "
                             "(float32 or bfloat16)")

    def init_state(self) -> TrainState:
        model = self.model.to(self.device, torch.float32)
        return TrainState(model, self.make_opt(model.parameters()),
                          torch.Generator().manual_seed(self.seed))

    def prepare_batch(self, batch) -> tuple:
        """Host batch ``(x, lengths, targets, mask)`` -> device tensors
        ``(x, lengths, targets)``, x in the compute dtype (converted on the
        host under bf16: half the bytes to copy); for ctcloss also the CTC
        targets and their lengths."""
        x, lengths, targets, _ = batch
        x = torch.from_numpy(np.asarray(x, dtype=np.float32))
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        host = [x, np.asarray(lengths, np.int32), np.asarray(targets, np.int64)]
        if self.is_ctc:
            host += prepare_ctc_targets(targets, x.shape[0])
        return tuple(torch.as_tensor(a).to(self.device) for a in host)

    def draw_seeds(self, ts: TrainState, batch_size: int) -> list:
        """``model.n_dropout_sites`` uint32 seeds, each a list of
        ``batch_size`` (one a video) for a model with per-video dropout."""
        n = ts.model.n_dropout_sites
        shape = ((n, batch_size) if getattr(ts.model, "per_video_dropout",
                                            False) else (n,))
        return torch.randint(0, 2 ** 32, shape, generator=ts.rng).tolist()

    def loss(self, model, x, lengths, targets, seeds, ctc=()) -> torch.Tensor:
        """The train forward's f32 loss, differentiable to the f32
        parameters; ``ctc`` is ctcloss's ``(targets, target_lengths)``."""
        if self.compute_dtype is None:
            out = model(x, lengths, train=True, seeds=seeds)
        else:
            params = {k: p.to(self.compute_dtype)
                      for k, p in model.named_parameters()}
            out = functional_call(model, params, (x, lengths),
                                  {"train": True, "seeds": seeds})
        if self.is_ctc:
            return self.loss_fn(out.to(torch.float32), lengths, *ctc)
        return self.loss_fn(out.to(torch.float32), targets)

    def train_step(self, ts: TrainState, batch, seeds=None) -> torch.Tensor:
        """One Adam step on a host batch or a prepared one; returns the
        loss (a 0-d tensor on the device).  The gradients stay in the
        parameters' ``.grad`` until the next step."""
        if not isinstance(batch[0], torch.Tensor):
            batch = self.prepare_batch(batch)
        x, lengths, targets, *ctc = batch
        if seeds is None:
            seeds = self.draw_seeds(ts, x.shape[0])
        ts.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(ts.model, x, lengths, targets, seeds, ctc)
        loss.backward()
        ts.optimizer.step()
        return loss.detach()

    def start_epoch(self, ts: TrainState) -> None:
        set_lr(ts.optimizer, self.lr_for_epoch(ts.epoch))


def predict_batches(model: torch.nn.Module, feed):
    """Yield per-video ``(pred_frames, label_frames)`` over a ``BatchFeed``,
    running the model in eval form on the device it lies on."""
    device = next(model.parameters()).device
    with torch.no_grad():
        for x, lengths, targets, _ in feed:
            b = x.shape[0]
            out = model(torch.from_numpy(x).to(device),
                        torch.from_numpy(lengths).to(device))
            preds = out.argmax(dim=-1).cpu().numpy()
            tgt = np.asarray(targets).reshape(b, -1)
            frame_level = preds.ndim == 2
            for i in range(b):
                if frame_level:
                    n = int(lengths[i]) if tgt.shape[1] > 1 else tgt.shape[1]
                    yield preds[i, :n], tgt[i, :n]
                else:
                    yield preds[i:i + 1], tgt[i, :1]


def evaluate(model: torch.nn.Module, feed) -> tuple[float, float]:
    """``(segment_accuracy, frame_accuracy)`` in percent, reference
    ``evaluate`` (``train.py:143-176``): frame argmax accuracy and the
    per-ground-truth-segment majority vote (bincount argmax, lowest index
    on ties)."""
    correct_frame = total_frame = 0
    correct_segment = total_segment = 0
    for pred, labels in predict_batches(model, feed):
        valid = labels != TARGET_PAD
        pred, labels = pred[valid], labels[valid]
        if labels.size == 0:
            continue
        total_frame += labels.size
        correct_frame += int((pred == labels).sum())
        seg_labels, bounds = run_length_segments(labels)
        for k, seg_label in enumerate(seg_labels):
            seg_pred = pred[bounds[k]:bounds[k + 1]]
            if seg_pred.size == 0:
                continue
            if int(seg_label) == int(np.bincount(seg_pred).argmax()):
                correct_segment += 1
        total_segment += len(seg_labels)
    frame_acc = 100.0 * correct_frame / max(total_frame, 1)
    seg_acc = 100.0 * correct_segment / max(total_segment, 1)
    return seg_acc, frame_acc
