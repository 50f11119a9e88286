"""``train.py`` CLI (counterpart of
``pytorch_video_action_tpu/cli/train_cli.py``): every flag of the JAX CLI,
plus ``--device {cuda,cpu}`` (``cuda`` by default; raises without a card).

Run: ``python -m pytorch_video_action_tpu_torch.cli.train_cli --model bigru
--epoch 10 --batchsize 8`` (or ``--model simple_fc``, the default,
``--model ctcloss``, ``--model vanilla_lstm``, ``--model bilstm``,
``--model bilstm_lm``, with the ``--lstm_*`` and ``--pred_mode`` flags,
``--model attn`` with ``--attn_head`` and ``--pred_mode``, ``--model
win_attn`` with ``--attn_head``, ``--model ms_tcn``).  Each epoch prints
the reference's loss and dev accuracy lines and saves
``models/{model}_{acc:.2f}_dev.npz`` when the dev segment accuracy
improves; a bilstm_lm checkpoint carries its BatchNorm running stats under
``__state__/``.  The inference CLIs serve an ms_tcn checkpoint under the
name ``mstcn_{acc:.2f}_dev``, as in JAX.

Accepted but not served yet, each raising ``NotImplementedError`` naming
its ROADMAP item before the data loads: ``--data_parallel N>1`` and
``--seq_parallel N>1`` (15), ``--resume`` and ``--cache_device`` (14),
``--lm_path`` (13), ``--train_mode segment`` and ``cont`` (6).
``--profile_dir`` raises naming item 14 when the first epoch starts.
``--use_pallas`` selects, as in the JAX package, ms_tcn's per-video
dropout stream (one seed a video a layer, the TPU layer kernel's own
form) over the default path's (one seed a layer over the whole ``[B, T,
C]`` batch); it changes nothing else: on the card the hand-written
kernels always run.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

import numpy as np
import torch

from ..data import BatchFeed, BucketBatchSampler, VideoDataset
from ..models import build_model, not_ported
from ..models.params import PORTED, load_jax_params, to_jax_params
from ..train import checkpoint as ckpt
from ..train.loop import Trainer, evaluate
from ..utils.observability import MetricsLogger, StepTimer, profile_trace
from .inference_cli import resolve_device


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--batchsize', dest='batchsize', type=int,
                        default=1, help='learning minibatch size')
    parser.add_argument('--epoch', dest='epoch', type=int, default=10,
                        help='epoch')
    parser.add_argument('--split', dest='split', type=int, default=0,
                        help='split')
    parser.add_argument('--lr', dest='lr', type=float, default=0.001,
                        help='learning rate')
    parser.add_argument('--lr_step_size', dest='lr_step_size', type=int,
                        default=30, help='learning rate')
    parser.add_argument('--lr_gamma', dest='lr_gamma', type=float, default=1,
                        help='learning rate')
    parser.add_argument('--num_workers', dest='num_workers', type=int,
                        default=0, help='[kept for CLI compat; data is fed '
                        'from host RAM, no worker processes]')
    parser.add_argument('--model', dest='model', default='simple_fc',
                        choices=['simple_fc', 'vanilla_lstm', 'bilstm',
                                 'bilstm_lm', 'attn', 'win_attn',
                                 'bigru', 'ms_tcn', 'ctcloss'],
                        help='Choose the type of model for learning')
    parser.add_argument('--pretrained_model', dest='pretrained_model',
                        default=None, help='pretrained_model file name')
    parser.add_argument('--train_mode', dest='train_mode', default='active',
                        choices=['segment', 'active', 'cont'],
                        help='segment: one instance = 1 segment; active: '
                             'video with SIL removed; cont: whole video')
    parser.add_argument('--pred_mode', dest='pred_mode', default='cont',
                        choices=['last', 'avg', 'cont'],
                        help='Classification for segment train-mode')
    parser.add_argument('--load_all', type=bool, nargs='?', const=True,
                        default=True,
                        help='[Deprecated] Now enforced to use --load_all')
    parser.add_argument('--eval', type=bool, nargs='?', const=True,
                        default=False,
                        help='Only evaluating model, not training')
    parser.add_argument('--lm_path', dest='lm_path', default=None,
                        help='Path to the language model for beam search decoding')
    parser.add_argument('--beam_size', dest='beam_size', type=int, default=5,
                        help='beam_size')
    parser.add_argument('--attn_head', dest='attn_head', type=int, default=4,
                        help='Number of head in MultiHeadAttention')
    parser.add_argument('--lstm_layer', dest='lstm_layer', type=int, default=2,
                        help='Number of LSTM layer')
    parser.add_argument('--lstm_dropout', dest='lstm_dropout', type=float,
                        default=0.5, help='Dropout rate of LSTM layer')
    parser.add_argument('--lstm_hidden1', dest='lstm_hidden1', type=int,
                        default=256, help='Number of LSTM Hidden neurons')
    parser.add_argument('--lstm_hidden2', dest='lstm_hidden2', type=int,
                        default=64, help='Number of linear hidden neuron')
    parser.add_argument('--data_dir', default='./data')
    parser.add_argument('--annot_path', default='.')
    parser.add_argument('--bucket_multiple', type=int, default=128,
                        help='Pad sequence length up to a multiple of this; '
                             '1 = exact-length parity bucketing')
    parser.add_argument('--use_pallas', type=bool, nargs='?', const=True,
                        default=False,
                        help="ms_tcn: the Pallas layer's per-video dropout "
                             'stream, as in JAX; nothing else changes: on '
                             'the card the hand-written kernels always run')
    parser.add_argument('--data_parallel', type=int, default=0,
                        help='Shard the batch over this many devices (0 = off)')
    parser.add_argument('--seq_parallel', type=int, default=0,
                        help='Shard the TIME axis over this many devices')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--resume', default=None,
                        help='Resume bundle path (params+optimizer+epoch)')
    parser.add_argument('--dtype', default='float32',
                        choices=['float32', 'bfloat16'],
                        help='Compute dtype for the model body (master '
                             'params, softmax and loss stay float32)')
    parser.add_argument('--cache_device', type=bool, nargs='?', const=True,
                        default=False,
                        help='Keep prepared batches resident on the device '
                             'across epochs')
    parser.add_argument('--metrics_jsonl', default=None,
                        help='Write structured per-epoch metrics (loss, dev '
                             'accuracies, frames/sec) to this JSONL file')
    parser.add_argument('--profile_dir', default=None,
                        help='Capture a profiler trace of the first training '
                             'epoch into this directory')
    parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                        help='cuda runs the hand-written kernels and raises '
                             'when no card is present; cpu runs their plain '
                             'PyTorch versions')
    return parser.parse_args(argv)


def _not_served(flag: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{flag} is not ported yet (ROADMAP.md, 'Modules to port', "
        f"item {item})")


def refuse_unserved(args) -> None:
    """Raise for every flag the port accepts but does not serve yet."""
    if args.data_parallel > 1:
        raise _not_served("--data_parallel > 1", 15)
    if args.seq_parallel > 1:
        raise _not_served("--seq_parallel > 1", 15)
    if args.resume is not None:
        raise _not_served("--resume", 14)
    if args.cache_device:
        raise _not_served("--cache_device", 14)
    if args.lm_path is not None:
        raise _not_served("--lm_path", 13)
    if args.model not in PORTED:
        raise not_ported(args.model)
    if args.train_mode != 'active':
        raise _not_served(f"--train_mode {args.train_mode}", 6)


def main(argv=None):
    args = parse_arguments(argv)
    refuse_unserved(args)  # before the (slow) data load
    device = resolve_device(args.device)
    os.makedirs("models", exist_ok=True)

    train_dataset = VideoDataset(
        data_dir=args.data_dir, annot_path=args.annot_path, part='train',
        split=args.split, mode=args.train_mode)
    dev_dataset = VideoDataset(
        data_dir=args.data_dir, annot_path=args.annot_path, part='dev',
        split=args.split, mode=args.train_mode)
    n_class = train_dataset.n_class

    # the reference sampler builds its batch list once and yields it,
    # order-shuffled, every epoch (data_utils.py:56-61)
    sampler = BucketBatchSampler(train_dataset.features, args.batchsize,
                                 seed=args.seed, freeze_composition=True)
    train_feed = BatchFeed(train_dataset, batch_sampler=sampler,
                           pred_mode=args.pred_mode,
                           train_mode=args.train_mode,
                           bucket_multiple=args.bucket_multiple)
    # metrics are padding-invariant, so the dev feed keeps the JAX CLI's
    # floor of 32 on the bucket multiple
    dev_feed = BatchFeed(dev_dataset, batch_size=max(args.batchsize, 1),
                         pred_mode=args.pred_mode,
                         train_mode=args.train_mode,
                         bucket_multiple=max(args.bucket_multiple, 32))

    model = build_model(args.model, n_class, pred_mode=args.pred_mode,
                        lstm_layer=args.lstm_layer,
                        lstm_dropout=args.lstm_dropout,
                        lstm_hidden1=args.lstm_hidden1,
                        lstm_hidden2=args.lstm_hidden2,
                        attn_head=args.attn_head,
                        use_pallas=args.use_pallas,
                        generator=torch.Generator().manual_seed(args.seed))
    trainer = Trainer(model, n_class, lr=args.lr,
                      lr_step_size=args.lr_step_size,
                      lr_gamma=args.lr_gamma, seed=args.seed,
                      compute_dtype=args.dtype, device=device)
    ts = trainer.init_state()

    if args.pretrained_model is not None:
        model_path = os.path.join('models', f'{args.pretrained_model}.npz')
        load_jax_params(ts.model, args.model,
                        *ckpt.load_params(model_path, with_state=True))
        print(f'Loaded pretrained model: {model_path}')

    if args.eval:
        if args.pretrained_model is None:
            print('[ERROR] Please provide the model path with '
                  '--pretrained_model <model_path>')
            print('Exiting.')
            return
        dev_acc, frame_acc = evaluate(ts.model, dev_feed)
        print('Dev accuracy by frame: {:.3f}'.format(frame_acc))
        print('Dev accuracy by segment: {:.3f}'.format(dev_acc))
        return
    return _train_loop(args, trainer, ts, train_feed, dev_feed)


def _train_loop(args, trainer, ts, train_feed, dev_feed):
    metrics = MetricsLogger(args.metrics_jsonl)
    previous_dev = 0.0
    first_epoch = ts.epoch
    for epoch in range(ts.epoch, args.epoch):
        ts.epoch = epoch
        trainer.start_epoch(ts)
        start = datetime.now()
        timer = StepTimer()
        running_loss = 0.0
        n_batches = 0
        print('Starting Epoch #{}, {} iterations'.format(
            epoch + 1, len(train_feed)))
        with profile_trace(args.profile_dir if epoch == first_epoch else None):
            for batch in train_feed:
                loss = trainer.train_step(ts, batch)
                timer.note(int(np.sum(batch[1])), loss)
                running_loss += float(loss)
                n_batches += 1
        epoch_s = timer.elapsed()
        delta_time = (datetime.now() - start).seconds / 60.0
        print('[%d, %5d] Train loss: %.3f (%.3f mins)' % (
            epoch + 1, n_batches, running_loss / max(n_batches - 1, 1),
            delta_time))
        dev_acc, frame_acc = evaluate(ts.model, dev_feed)
        print('Dev accuracy by frame: {:.3f}'.format(frame_acc))
        print('Dev accuracy by segment: {:.3f} (Current best: {:.3f})'.format(
            dev_acc, previous_dev))
        metrics.epoch(epoch + 1, running_loss / max(n_batches - 1, 1),
                      frame_acc, dev_acc, trainer.lr_for_epoch(epoch),
                      epoch_s, timer.frames)
        if dev_acc > previous_dev:
            print('{} ==> {}'.format(dev_acc, previous_dev))
            model_path = 'models/{}.npz'.format(
                ckpt.checkpoint_name(args.model, dev_acc))
            ckpt.save_params(model_path, *to_jax_params(
                args.model, ts.model.state_dict(), with_state=True))
            metrics.log("checkpoint", path=model_path,
                        dev_segment_acc=round(dev_acc, 4))
            previous_dev = dev_acc

    print('Finished Training, Dev Accuracy: ', previous_dev)
    return previous_dev


if __name__ == '__main__':
    main()
