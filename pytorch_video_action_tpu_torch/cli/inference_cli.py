"""``inference.py`` CLI — per-segment multi-model ensemble voting
(counterpart of ``pytorch_video_action_tpu/cli/inference_cli.py``, flags of
reference ``inference.py:16-30``), plus ``--device``.

Run: ``python -m pytorch_video_action_tpu_torch.cli.inference_cli
--pretrained_model bigru_73.52_dev --prob big --part test``.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

import torch

from ..data.dataset import VideoDataset
from ..infer.ensemble import run_ensemble
from ..infer.loader import load_models
from ..utils.csvout import write_submission


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--pretrained_model', dest='pretrained_model', nargs='+',
                        required=True,
                        help='pretrained_model filename, filename must be '
                             'standard ${model}_${accuracy}_dev, priority is '
                             'given based on the asc order')
    parser.add_argument('--load_all', type=bool, nargs='?', const=True,
                        default=True,
                        help='Load all data into RAM')
    parser.add_argument('--prob', dest='prob', required=True,
                        choices=['small', 'big'],
                        help='probability smaller or bigger better')
    parser.add_argument('--part', dest='part', default='test',
                        choices=['dev', 'test'], help='infer the dev or test')
    parser.add_argument('--split', dest='split', type=int, default=0,
                        help='split')
    parser.add_argument('--attn_head', type=int, default=4,
                        help='heads for attn checkpoints (the reference '
                             'inference parsers omit this and crash)')
    parser.add_argument('--data_dir', default='./data')
    parser.add_argument('--annot_path', default='.')
    parser.add_argument('--models_dir', default='models')
    parser.add_argument('--results_dir', default='results')
    parser.add_argument('--bucket_multiple', type=int, default=128)
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--dtype', default='float32',
                        choices=['float32', 'bfloat16'],
                        help='forward-pass precision; predictions can differ '
                             'from float32 on near-tied frames')
    parser.add_argument('--data_parallel', type=int, default=0,
                        help='shard prediction batches over this many devices '
                             '(0 = off)')
    parser.add_argument('--parity_quirks', type=bool, nargs='?', const=True,
                        default=False,
                        help="reproduce the reference's literal argsort[1] "
                             'zero-avoidance and its dropout at test time')
    parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                        help='cuda runs the hand-written kernels and raises '
                             'when no card is present; cpu runs their plain '
                             'PyTorch versions')
    return parser.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    if name == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda: no CUDA device is available '
                           '(pass --device cpu to run on the CPU)')
    return torch.device(name)


def main(argv=None):
    args = parse_arguments(argv)
    if args.data_parallel > 1:
        raise NotImplementedError(
            '--data_parallel > 1 is not ported yet (ROADMAP.md, '
            "'Modules to port', item 15)")
    device = resolve_device(args.device)
    os.makedirs(args.results_dir, exist_ok=True)
    if args.part == 'dev':
        split, mode = args.split, 'active'
    else:
        split, mode = 1, None
    dataset = VideoDataset(
        data_dir=args.data_dir, annot_path=args.annot_path,
        part=args.part, split=split, mode=mode,
    )
    models = load_models(args.pretrained_model, dataset.n_class,
                         models_dir=args.models_dir, device=device,
                         attn_head=args.attn_head)
    if len(models) == 0:
        print('No model is loaded...')
        return 0
    print('Start predicting...')
    out = run_ensemble(
        dataset, models, part=args.part, prob_pref=args.prob,
        quirk_argsort1=args.parity_quirks,
        bucket_multiple=args.bucket_multiple, batch_size=args.batch_size,
        # the reference inference.py never calls net.eval() (dropout stays
        # on at test time, inference.py:100); only --parity_quirks keeps that
        dropout_at_test=args.parity_quirks, dtype=args.dtype,
    )
    if args.part == 'dev':
        return out
    stamp = datetime.now().strftime('%Y_%m_%d_%H_%M_%S')
    result_path = os.path.join(
        args.results_dir,
        'result_{}_{}'.format('_'.join(args.pretrained_model), stamp),
    )
    print(f'Writing results to {result_path}...')
    write_submission(result_path, out)
    return result_path


if __name__ == '__main__':
    main()
