"""The port's training path (``pytorch_video_action_tpu_torch/data``,
``train/`` and ``cli/train_cli.py``) against the JAX package's.

The port runs on the CPU, where the GRU layer's train-form forward and
backward are their plain PyTorch versions; the JAX package runs its XLA
path (Pallas is off on the CPU).  Inputs are made from numpy seeds and
handed to both; parameters carry over with ``from_jax_params``; dropout
seeds are the ones the JAX step derives from its PRNG key.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_video_action_tpu.data import BatchFeed as JBatchFeed
from pytorch_video_action_tpu.data import BucketBatchSampler as JSampler
from pytorch_video_action_tpu.data import VideoDataset as JVideoDataset
from pytorch_video_action_tpu.data.collate import pad_batch as jpad_batch
from pytorch_video_action_tpu.models import ModelDef
from pytorch_video_action_tpu.models import build_model as jbuild
from pytorch_video_action_tpu.models import gru as jgru
from pytorch_video_action_tpu.ops import hashmask as jhash
from pytorch_video_action_tpu.train import checkpoint as jckpt
from pytorch_video_action_tpu.train import losses as jlosses
from pytorch_video_action_tpu.train.loop import Trainer as JTrainer
from pytorch_video_action_tpu.train.loop import evaluate as jevaluate
from pytorch_video_action_tpu.utils import observability as jobs
from pytorch_video_action_tpu_torch.cli import inference_cli as pinfer
from pytorch_video_action_tpu_torch.cli import train_cli
from pytorch_video_action_tpu_torch.data import (BatchFeed,
                                                 BucketBatchSampler,
                                                 VideoDataset, pad_batch)
from pytorch_video_action_tpu_torch.models.gru import BiGRU, BiGRUConfig
from pytorch_video_action_tpu_torch.models.params import from_jax_params
from pytorch_video_action_tpu_torch.train import losses as plosses
from pytorch_video_action_tpu_torch.train.loop import Trainer, evaluate
from pytorch_video_action_tpu_torch.train.optim import make_optimizer
from pytorch_video_action_tpu_torch.utils import observability as pobs

NARROW = dict(gru_layer=2, hidden_dim_1=32, n_class=7)  # H=16
LR = 1e-3


@pytest.fixture
def one_thread():
    # single-threaded reductions, for the reason given in
    # test_train_step_parity.py: under load OpenMP team sizes vary, changing
    # reduction splits, and a near-zero gradient element can flip the sign
    # of the first Adam step
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------- data


def _lengths(seed, n=23):
    rng = np.random.default_rng(seed)
    return [np.zeros((int(v), 1)) for v in rng.integers(1, 9, n)]  # ties


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("freeze", [False, True])
def test_sampler_gives_the_jax_batches(seed, freeze):
    inputs = _lengths(seed)
    for bs in (1, 4, 5):
        want = JSampler(inputs, bs, seed=seed, freeze_composition=freeze)
        got = BucketBatchSampler(inputs, bs, seed=seed,
                                 freeze_composition=freeze)
        assert len(got) == len(want) == got.batch_count()
        for _ in range(3):  # epochs
            assert list(got) == list(want)


class _Items:
    """A dataset of (features, labels) items, as VideoDataset gives."""

    def __init__(self, seed, n=7, labels=True):
        rng = np.random.default_rng(seed)
        self.items = []
        for _ in range(n):
            t = int(rng.integers(1, 70))
            lab = (rng.integers(0, 5, t) if labels
                   else np.zeros((0,), np.int64))
            self.items.append((rng.normal(size=(t, 400)).astype(np.float32),
                               lab))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("pred_mode", ["cont", "last"])
@pytest.mark.parametrize("mult", [1, 32, 128])
def test_pad_batch_equals_jax(pred_mode, mult):
    for labels in (True, False):
        items = _Items(mult, labels=labels).items
        got = pad_batch(items, batchsize=len(items) + 2, pred_mode=pred_mode,
                        bucket_multiple=mult)
        want = jpad_batch(items, batchsize=len(items) + 2,
                          pred_mode=pred_mode, bucket_multiple=mult)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_batch_feed_equals_jax():
    data = _Items(3, n=11)
    feeds = [(BatchFeed(data, batch_sampler=BucketBatchSampler(
                  [f for f, _ in data.items], 3, seed=4), bucket_multiple=32),
              JBatchFeed(data, batch_sampler=JSampler(
                  [f for f, _ in data.items], 3, seed=4), bucket_multiple=32)),
             (BatchFeed(data, batch_size=4, shuffle=True, seed=5),
              JBatchFeed(data, batch_size=4, shuffle=True, seed=5))]
    for got, want in feeds:
        assert len(got) == len(want)
        for _ in range(2):
            n = 0
            for gb, wb in zip(got, want):
                n += 1
                for g, w in zip(gb, wb):
                    assert g.dtype == w.dtype and np.array_equal(g, w)
            assert n == len(want)


def test_segment_train_mode_raises():
    with pytest.raises(NotImplementedError, match="item 6"):
        BatchFeed(_Items(0), train_mode="segment")
    with pytest.raises(NotImplementedError, match="item 6"):
        pad_batch(_Items(0).items, train_mode="segment")


@pytest.mark.parametrize("all_pad", [False, True])
def test_losses_equal_jax(all_pad):
    rng = np.random.default_rng(int(all_pad))
    logits = rng.normal(size=(3, 17, 6)).astype(np.float32)
    targets = rng.integers(0, 6, 3 * 17)
    targets[::4] = -1
    if all_pad:
        targets[:] = -1  # the count is clamped to 1: loss 0, not NaN
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    cases = [(plosses.nll_loss, jlosses.nll_loss, lp.numpy()),
             (plosses.cross_entropy_loss, jlosses.cross_entropy_loss, logits)]
    for pfn, jfn, inp in cases:
        got = pfn(torch.from_numpy(inp), torch.from_numpy(targets)).item()
        want = float(jfn(jnp.asarray(inp), jnp.asarray(targets)))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
        assert np.isfinite(got)


def test_lr_schedule_gates_like_jax():
    from pytorch_video_action_tpu.train.optim import make_optimizer as jmake

    for step, gamma in ((30, 1.0), (2, 0.5), (0, 0.5)):
        _, plr = make_optimizer(LR, step, gamma)
        _, jlr = jmake(LR, step, gamma)
        assert [plr(e) for e in range(7)] == [jlr(e) for e in range(7)]


# ---------------------------------------------------------------- trainer


def _narrow_jax():
    cfg = jgru.BiGRUConfig(**NARROW)
    return ModelDef("bigru", cfg, lambda rng: jgru.init(rng, cfg),
                    lambda p, x, l, **kw: jgru.apply(p, cfg, x, l, **kw),
                    "log_probs")


def _batch(seed, b=3, t=24):
    rng = np.random.default_rng(seed)
    lengths = np.array([t, t // 2 + 1, 1][:b], np.int32)
    x = rng.normal(size=(b, t, 400)).astype(np.float32)
    x[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    targets = rng.integers(0, NARROW["n_class"], (b, t))
    targets[np.arange(t)[None, :] >= lengths[:, None]] = -1
    mask = np.arange(t)[None, :] < lengths[:, None]
    return x, lengths, targets.reshape(-1), mask


def _jax_seeds(rng_key, n_layers):
    """The dropout seeds of one JAX train step: loop.py:174 splits the
    state's key, models/gru.py:37 splits the step key into input and RNN
    keys, rnn.py:522 splits once per inter-layer site."""
    _, sub = jax.random.split(rng_key)
    r_in, r_rnn = jax.random.split(sub, 2)
    seeds = [int(jhash.rng_seed_u32(r_in))]
    for _ in range(n_layers - 1):
        r_rnn, s = jax.random.split(r_rnn)
        seeds.append(int(jhash.rng_seed_u32(s)))
    return seeds


def _flat(tree):
    return {k: np.asarray(v) for k, v in jckpt._flatten(tree).items()}


def _assert_params_close(model, tree, path=""):
    """Adam steps are LR-sized; on elements whose true gradient is near 0
    the first step's sign can flip between two correct f32 versions
    (test_train_step_parity.py): at most 1 in 1000 elements beyond 1e-4,
    none beyond 2.5 LR."""
    want = _flat(tree)
    got = {k.replace(".", "/"): v.detach().numpy()
           for k, v in model.state_dict().items()}
    assert got.keys() == want.keys()
    for k in want:
        diff = np.abs(got[k].astype(np.float64) - want[k])
        assert int((diff > 1e-4).sum()) <= max(1, diff.size // 1000), k
        assert diff.max() <= 2.5 * LR, k


def test_trainer_steps_equal_jax_trainer(one_thread):
    """Three steps with dropout on, from the same parameters and with the
    JAX step's seeds: loss, gradients and parameters."""
    mdef = _narrow_jax()
    jtr = JTrainer(mdef, NARROW["n_class"], lr=LR, seed=0)
    jts = jtr.init_state()
    model = BiGRU(BiGRUConfig(**NARROW))
    model.load_state_dict(from_jax_params(
        "bigru", jax.tree.map(np.asarray, jts.params)))
    tr = Trainer(model, NARROW["n_class"], lr=LR, seed=0, device="cpu")
    ts = tr.init_state()

    @jax.jit
    def jloss_grad(p, x, lengths, targets, key):
        def jloss(q):
            out = mdef.apply(q, x, lengths, train=True, rng=key)
            return jlosses.nll_loss(out.astype(jnp.float32), targets)
        return jax.value_and_grad(jloss)(p)

    for step in range(3):
        batch = _batch(step)
        x, lengths, targets, _ = batch
        seeds = _jax_seeds(jts.rng, NARROW["gru_layer"])
        _, sub = jax.random.split(jts.rng)
        want_loss, want_grads = jloss_grad(
            jts.params, jnp.asarray(x), jnp.asarray(lengths),
            jnp.asarray(targets), sub)
        want_grads = _flat(want_grads)
        jtr.train_step(jts, batch)
        loss = tr.train_step(ts, batch, seeds=seeds)
        # f32, the same sums in another order
        assert abs(loss.item() - float(want_loss)) <= 1e-5
        for name, p in ts.model.named_parameters():
            w = want_grads[name.replace(".", "/")]
            g = p.grad.numpy()
            assert np.abs(g - w).max() <= 1e-5 * max(1.0, np.abs(w).max()), \
                (step, name)
        _assert_params_close(ts.model, jts.params)


def test_gradients_reach_every_parameter():
    model = BiGRU(BiGRUConfig(**NARROW),
                  generator=torch.Generator().manual_seed(0))
    tr = Trainer(model, NARROW["n_class"], lr=LR, seed=0, device="cpu")
    ts = tr.init_state()
    tr.train_step(ts, _batch(0))
    for name, p in ts.model.named_parameters():
        assert p.grad is not None, name
        assert p.grad.abs().max().item() > 0.0, name


def test_bf16_step_keeps_f32_masters():
    """The bf16 step rounds the inputs, the weight copies, ys, the residuals
    and the gate gradients to 8 bits; its loss stays within 1e-2 relative
    of the f32 step's from the same parameters and seeds (measured here:
    8.6e-5)."""
    losses = {}
    for dt in ("float32", "bfloat16"):
        model = BiGRU(BiGRUConfig(**NARROW),
                      generator=torch.Generator().manual_seed(1))
        tr = Trainer(model, NARROW["n_class"], lr=LR, seed=0,
                     compute_dtype=dt, device="cpu")
        ts = tr.init_state()
        losses[dt] = tr.train_step(ts, _batch(1), seeds=[1, 2]).item()
        for name, p in ts.model.named_parameters():
            assert p.dtype == torch.float32, name
            assert p.grad.dtype == torch.float32, name
            state = ts.optimizer.state[p]
            assert state["exp_avg"].dtype == torch.float32, name
            assert state["exp_avg_sq"].dtype == torch.float32, name
    assert abs(losses["bfloat16"] - losses["float32"]) <= \
        1e-2 * abs(losses["float32"])


def test_trainer_needs_a_card_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(BiGRU(BiGRUConfig(**NARROW)), NARROW["n_class"])


def _dev_feeds(root, jax_batch=2, bucket=32):
    kw = dict(data_dir=os.path.join(str(root), "data"),
              annot_path=str(root), part="dev", split=0, mode="active")
    pds = VideoDataset(verbose=False, **kw)
    jds = JVideoDataset(verbose=False, **kw)
    return (BatchFeed(pds, batch_size=jax_batch, bucket_multiple=bucket),
            JBatchFeed(jds, batch_size=jax_batch, bucket_multiple=bucket))


def test_evaluate_equals_jax(synthetic_root, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    pfeed, jfeed = _dev_feeds(synthetic_root)
    cfg = dict(NARROW, n_class=5)
    jcfg = jgru.BiGRUConfig(**cfg)
    mdef = ModelDef("bigru", jcfg, lambda rng: jgru.init(rng, jcfg),
                    lambda p, x, l, **kw: jgru.apply(p, jcfg, x, l, **kw),
                    "log_probs")
    params = mdef.init(jax.random.PRNGKey(3))
    model = BiGRU(BiGRUConfig(**cfg))
    model.load_state_dict(from_jax_params(
        "bigru", jax.tree.map(np.asarray, params)))
    assert evaluate(model, pfeed) == jevaluate(mdef, params, jfeed)


# -------------------------------------------------------------------- CLI


def _argv(root, *extra):
    return ["--model", "bigru", "--device", "cpu", "--epoch", "2",
            "--batchsize", "2", "--bucket_multiple", "32",
            "--data_dir", os.path.join(str(root), "data"),
            "--annot_path", str(root), *extra]


def test_train_cli_end_to_end(synthetic_root, tmp_path, monkeypatch):
    """Train on the synthetic tree; the JAX package scores the checkpoint to
    the dev accuracy the port printed, and the port's inference CLI serves
    it."""
    monkeypatch.chdir(tmp_path)
    best = train_cli.main(_argv(synthetic_root, "--metrics_jsonl", "m.jsonl"))
    name = f"bigru_{best:.2f}_dev"
    assert os.path.exists(os.path.join("models", f"{name}.npz"))
    records = [json.loads(line) for line in open("m.jsonl")]
    epochs = [r for r in records if r["event"] == "epoch"]
    assert [r["epoch"] for r in epochs] == [1, 2]
    assert all(np.isfinite(r["train_loss"]) for r in epochs)

    n_class = 5
    mdef = jbuild("bigru", n_class)
    params = jckpt.load_params(os.path.join("models", f"{name}.npz"))
    _, jfeed = _dev_feeds(synthetic_root)
    seg_acc, _ = jevaluate(mdef, params, jfeed)
    assert seg_acc == best

    acc = pinfer.main(["--pretrained_model", name, "--prob", "big",
                       "--part", "dev", "--device", "cpu",
                       "--data_dir", os.path.join(str(synthetic_root), "data"),
                       "--annot_path", str(synthetic_root),
                       "--bucket_multiple", "32"])
    assert 0.0 <= acc <= 100.0


@pytest.mark.parametrize("extra,item", [
    (["--data_parallel", "2"], 15), (["--seq_parallel", "2"], 15),
    (["--resume", "r.npz"], 14), (["--cache_device"], 14),
    (["--lm_path", "lm.arpa"], 13),
    (["--model", "vanilla_lstm", "--lm_path", "lm.arpa"], 13),
    (["--model", "ms_tcn", "--seq_parallel", "2"], 15),
    (["--train_mode", "segment"], 6), (["--train_mode", "cont"], 6)])
def test_unserved_flags_raise_before_the_data_loads(tmp_path, monkeypatch,
                                                    extra, item):
    monkeypatch.chdir(tmp_path)
    argv = _argv(tmp_path / "no_such_tree") + extra
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        train_cli.main(argv)


@pytest.mark.parametrize("extra", [["--model", "simple_fc"], [],
                                   ["--model", "ctcloss"]],
                         ids=["simple_fc", "default_model", "ctcloss"])
def test_ported_families_get_past_refuse_unserved(tmp_path, monkeypatch,
                                                  extra):
    """simple_fc (the CLI's default --model) and ctcloss, which ROADMAP item
    12 once refused here, pass ``refuse_unserved`` and reach the data
    load, where the missing tree raises."""
    monkeypatch.chdir(tmp_path)
    argv = _argv(tmp_path / "no_such_tree") + extra
    if not extra:
        argv = [a for a in argv if a not in ("--model", "bigru")]
    train_cli.refuse_unserved(train_cli.parse_arguments(argv))
    with pytest.raises(FileNotFoundError, match="no_such_tree"):
        train_cli.main(argv)


def test_ms_tcn_gets_past_the_flag_checks(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = _argv(tmp_path / "no_such_tree") + ["--model", "ms_tcn"]
    with pytest.raises(FileNotFoundError, match="no_such_tree"):
        train_cli.main(argv)


def test_profile_dir_raises_naming_its_item(synthetic_root, tmp_path,
                                            monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="item 14"):
        train_cli.main(_argv(synthetic_root, "--profile_dir", "prof"))


def test_device_cuda_raises_without_card(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _argv(tmp_path / "no_such_tree")
    argv[argv.index("--device") + 1] = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(argv)


def test_use_pallas_is_accepted_and_changes_nothing():
    args = train_cli.parse_arguments(_argv("x", "--use_pallas"))
    assert args.use_pallas is True
    train_cli.refuse_unserved(args)


def test_metrics_records_match_jax(tmp_path):
    calls = [("log", ("checkpoint",), {"path": "p", "dev_segment_acc": 1.5}),
             ("epoch", (1, 0.5, 60.0, 50.0, 1e-3, 2.0, 400), {})]
    out = {}
    for name, mod in (("port", pobs), ("jax", jobs)):
        logger = mod.MetricsLogger(str(tmp_path / f"{name}.jsonl"))
        for meth, args, kw in calls:
            getattr(logger, meth)(*args, **kw)
        out[name] = [{k: v for k, v in json.loads(line).items() if k != "time"}
                     for line in open(tmp_path / f"{name}.jsonl")]
    assert out["port"] == out["jax"]
    timer = pobs.StepTimer()
    timer.note(10, torch.zeros(()))
    assert timer.frames == 10 and timer.frames_per_sec() > 0
