"""The port's vanilla_lstm (``pytorch_video_action_tpu_torch/models/
lstm.py::VanillaLSTM``), its weight carry-over, checkpoints, ``Trainer``
steps, ``evaluate`` and CLIs against the JAX package.

The port runs on the CPU, where the LSTM scan's kernels are their plain
PyTorch versions; the JAX package runs its XLA scan (Pallas is off on the
CPU).  Inputs come from numpy seeds, parameters carry over with
``from_jax_params``, and dropout seeds are the ones the JAX step derives
from its PRNG key.  f32: 1e-5 of each tensor's largest element (at least
1), the same sums in another order; bf16 3e-2.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_video_action_tpu.cli import inference_cli as jcli
from pytorch_video_action_tpu.data import BatchFeed as JBatchFeed
from pytorch_video_action_tpu.data import VideoDataset as JVideoDataset
from pytorch_video_action_tpu.models import build_model as jbuild
from pytorch_video_action_tpu.ops import hashmask as jhash
from pytorch_video_action_tpu.train import checkpoint as jckpt
from pytorch_video_action_tpu.train import losses as jlosses
from pytorch_video_action_tpu.train.loop import Trainer as JTrainer
from pytorch_video_action_tpu.train.loop import evaluate as jevaluate
from pytorch_video_action_tpu_torch.cli import inference_cli as pcli
from pytorch_video_action_tpu_torch.cli import train_cli
from pytorch_video_action_tpu_torch.data import BatchFeed, VideoDataset
from pytorch_video_action_tpu_torch.models import build_model
from pytorch_video_action_tpu_torch.models.params import (from_jax_params,
                                                          load_jax_params,
                                                          to_jax_params)
from pytorch_video_action_tpu_torch.ops import rnn_scan as RS
from pytorch_video_action_tpu_torch.train import checkpoint as pckpt
from pytorch_video_action_tpu_torch.train.loop import Trainer, evaluate

# the train CLI's flags at a narrow width: H=24, 2 layers
NARROW = dict(lstm_layer=2, lstm_hidden1=24)
N_CLASS = 7
LR = 1e-3
# the inference CLIs' defaults, for the train CLI
SERVE_FLAGS = ["--lstm_hidden1", "64", "--lstm_layer", "1", "--lstm_dropout",
               "0"]


@pytest.fixture
def one_thread():
    # single-threaded reductions, as in test_torch_train.py: a near-zero
    # gradient element can otherwise flip the sign of the first Adam step
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed=0, n_class=N_CLASS, **flags):
    kw = dict(NARROW, **flags)
    mdef = jbuild("vanilla_lstm", n_class, **kw)
    params = mdef.init(jax.random.PRNGKey(seed))
    model = build_model("vanilla_lstm", n_class, **kw)
    model.load_state_dict(from_jax_params(
        "vanilla_lstm", jax.tree.map(np.asarray, params)))
    return mdef, params, model


def _batch(seed, b=3, t=24, n_class=N_CLASS, pred_mode="cont"):
    rng = np.random.default_rng(seed)
    lengths = np.array([t, t // 2 + 1, 1][:b], np.int32)
    x = rng.normal(size=(b, t, 400)).astype(np.float32)
    x[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    if pred_mode == "last":
        return x, lengths, rng.integers(0, n_class, b), None
    targets = rng.integers(0, n_class, (b, t))
    targets[np.arange(t)[None, :] >= lengths[:, None]] = -1
    return x, lengths, targets.reshape(-1), None


def _jax_seeds(key, n_layers):
    """The dropout seeds of one JAX forward from ``key``: apply_vanilla_lstm
    hands the key to the stack, which splits it once per inter-layer site
    (rnn.py:522)."""
    seeds = []
    for _ in range(n_layers - 1):
        key, sub = jax.random.split(key)
        seeds.append(int(jhash.rng_seed_u32(sub)))
    return seeds


def _flat(tree):
    return {k: np.asarray(v) for k, v in jckpt._flatten(tree).items()}


def _close(got, want, what, tol=1e-5):
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= tol, (what, err)


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("mode", ["cont", "last", "avg"])
def test_logprobs_and_gradients_match_jax(mode, train):
    """Eval form, and train form with the JAX dropout seed between the two
    layers: log-probs and the gradients of a cotangent over them.  Mode
    ``last`` takes the last valid frame; ``avg``, as in JAX, runs per
    frame."""
    mdef, params, model = _pair(seed=1, pred_mode=mode)
    x, lengths, _, _ = _batch(1, t=30)
    key = jax.random.PRNGKey(5) if train else None
    frames = mode != "last"
    shape = (3, 30, N_CLASS) if frames else (3, N_CLASS)
    cot = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    valid = np.arange(30)[None, :] < lengths[:, None]
    if frames:  # padded frames' log-probs are discarded downstream
        cot *= valid[:, :, None]

    def jf(p):
        out = mdef.apply(p, jnp.asarray(x), jnp.asarray(lengths),
                         train=train, rng=key)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(jf, has_aux=True)(params)
    out = model(torch.from_numpy(x), torch.from_numpy(lengths), train=train,
                seeds=_jax_seeds(key, 2) if train else None)
    (out * torch.from_numpy(cot)).sum().backward()
    got, want = out.detach().numpy(), np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    if frames:
        got, want = got[valid], want[valid]
    _close(got, want, "log-probs")
    jgrads = _flat(jgrads)
    for k, p in model.named_parameters():
        _close(p.grad.numpy(), jgrads[k.replace(".", "/")], k)


def test_bf16_forward_close_to_f32():
    """The bf16 model against the f32 one: 3e-2 of the log-probs' largest
    element (the scan rounds h to bf16 before each product)."""
    _, _, model = _pair(seed=2)
    x, lengths, _, _ = _batch(3, t=30)
    args = (torch.from_numpy(x), torch.from_numpy(lengths))
    with torch.no_grad():
        want = model(*args).numpy()
        got = model.to(torch.bfloat16)(args[0].to(torch.bfloat16),
                                       args[1]).numpy()
    valid = np.arange(30)[None, :] < args[1].numpy()[:, None]
    _close(got[valid], want[valid], "bf16 log-probs", 3e-2)


@pytest.mark.parametrize("flags", [
    dict(defaults=True), dict(), dict(lstm_layer=3, lstm_hidden1=40,
                                      lstm_dropout=0.2, pred_mode="last")])
def test_build_model_follows_the_jax_factory(flags):
    """The same configuration, parameter shapes and dropout sites as the
    JAX package's build_model: the inference defaults (H=64, 1 layer,
    dropout 0) and the train CLI's flags (H = --lstm_hidden1)."""
    mdef = jbuild("vanilla_lstm", 48, **flags)
    model = build_model("vanilla_lstm", 48, **flags)
    assert dataclasses.asdict(model.cfg) == dataclasses.asdict(mdef.config)
    assert not model.stateful and model.name == "vanilla_lstm"
    want = {k: tuple(v.shape) for k, v in jckpt._flatten(
        mdef.init(jax.random.PRNGKey(0))).items()}
    got = {k.replace(".", "/"): tuple(v.shape)
           for k, v in model.state_dict().items()}
    assert got == want
    assert model.n_dropout_sites == mdef.config.lstm_layer - 1


def test_train_forward_needs_seeds():
    model = build_model("vanilla_lstm", N_CLASS, **NARROW)
    with pytest.raises(ValueError, match="seeds"):
        model(torch.zeros(1, 4, 400), torch.tensor([4]), train=True)


def test_checkpoints_round_trip_through_either_package(tmp_path):
    """Written by the port and read by JAX, written by JAX and read by the
    port, bit for bit."""
    _, params, model = _pair(seed=4)
    tree = to_jax_params("vanilla_lstm", model.state_dict())
    want = _flat(params)
    assert _flat(tree).keys() == want.keys()
    assert all(np.array_equal(_flat(tree)[k], want[k]) for k in want)
    path = str(tmp_path / "vanilla_lstm_12.34_dev")
    pckpt.save_params(path, tree)
    got = _flat(jckpt.load_params(path + ".npz"))
    assert all(np.array_equal(got[k], want[k]) for k in want)
    jpath = str(tmp_path / "j.npz")
    jckpt.save_params(jpath, params)
    back = build_model("vanilla_lstm", N_CLASS, **NARROW)
    load_jax_params(back, "vanilla_lstm", pckpt.load_params(jpath))
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


# ---------------------------------------------------------------- trainer


@pytest.mark.parametrize("recompute", [False, True])
def test_trainer_steps_equal_jax_trainer(one_thread, monkeypatch, recompute):
    """Three steps with dropout on, from the same parameters and with the
    JAX step's seeds: loss, gradients and parameters, with the saved-gates
    and with the recompute backward."""
    monkeypatch.setattr(RS, "RECOMPUTE_BWD", recompute)
    mdef, _, model = _pair()
    jtr = JTrainer(mdef, N_CLASS, lr=LR, seed=0)
    jts = jtr.init_state()
    tr = Trainer(model, N_CLASS, lr=LR, seed=0, device="cpu")
    ts = tr.init_state()

    @jax.jit
    def jloss_grad(p, x, lengths, targets, key):
        def jloss(q):
            out = mdef.apply(q, x, lengths, train=True, rng=key)
            return jlosses.nll_loss(out.astype(jnp.float32), targets)
        return jax.value_and_grad(jloss)(p)

    for step in range(3):
        batch = _batch(10 + step)
        x, lengths, targets, _ = batch
        _, sub = jax.random.split(jts.rng)
        want_loss, want_grads = jloss_grad(
            jts.params, jnp.asarray(x), jnp.asarray(lengths),
            jnp.asarray(targets), sub)
        want_grads = _flat(want_grads)
        jtr.train_step(jts, batch)
        loss = tr.train_step(ts, batch, seeds=_jax_seeds(sub, 2))
        assert abs(loss.item() - float(want_loss)) <= 1e-5 * max(
            1.0, abs(float(want_loss)))
        for pname, p in ts.model.named_parameters():
            _close(p.grad.numpy(), want_grads[pname.replace(".", "/")],
                   (step, pname))
        # Adam steps are LR-sized; a near-zero gradient element's first
        # step may flip sign between two correct f32 versions
        want = _flat(jts.params)
        for pname, p in ts.model.named_parameters():
            diff = np.abs(p.detach().numpy().astype(np.float64)
                          - want[pname.replace(".", "/")])
            assert int((diff > 1e-4).sum()) <= max(1, diff.size // 1000)
            assert diff.max() <= 2.5 * LR


def _dev_feeds(root, batch=2, bucket=32):
    kw = dict(data_dir=os.path.join(str(root), "data"),
              annot_path=str(root), part="dev", split=0, mode="active")
    return (BatchFeed(VideoDataset(verbose=False, **kw), batch_size=batch,
                      bucket_multiple=bucket),
            JBatchFeed(JVideoDataset(verbose=False, **kw), batch_size=batch,
                       bucket_multiple=bucket))


def test_evaluate_equals_jax(synthetic_root, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    pfeed, jfeed = _dev_feeds(synthetic_root)
    mdef, params, model = _pair(seed=3, n_class=5)
    assert evaluate(model, pfeed) == jevaluate(mdef, params, jfeed)


# -------------------------------------------------------------------- CLI


def _train(root, extra=()):
    return train_cli.main([
        "--model", "vanilla_lstm", "--device", "cpu", "--epoch", "2",
        "--batchsize", "2", "--bucket_multiple", "32", "--data_dir",
        os.path.join(str(root), "data"), "--annot_path", str(root), *extra])


def test_train_cli_at_its_defaults(synthetic_root, tmp_path, monkeypatch):
    """The train CLI's defaults (H=256, 2 layers, dropout 0.5) write
    ``vanilla_lstm_{acc:.2f}_dev.npz``; the JAX package scores it to the
    dev accuracy the port printed."""
    monkeypatch.chdir(tmp_path)
    best = _train(synthetic_root)
    params = jckpt.load_params(os.path.join(
        "models", f"vanilla_lstm_{best:.2f}_dev.npz"))
    assert params["rnn"][0]["fwd"]["wh"].shape == (256, 1024)
    assert len(params["rnn"]) == 2 and "bwd" not in params["rnn"][0]
    _, jfeed = _dev_feeds(synthetic_root)
    seg_acc, _ = jevaluate(jbuild("vanilla_lstm", 5), params, jfeed)
    assert seg_acc == best


@pytest.mark.parametrize("with_bigru", [False, True])
def test_trained_checkpoint_served_byte_identical_to_jax(
        synthetic_root, tmp_path, monkeypatch, with_bigru):
    """A checkpoint the train CLI writes at the inference CLIs' defaults,
    served alone and in an ensemble with a bigru one: the port's test CSV
    is the JAX CLI's, byte for byte."""
    monkeypatch.chdir(tmp_path)
    best = _train(synthetic_root, SERVE_FLAGS)
    names = [f"vanilla_lstm_{best:.2f}_dev"]
    if with_bigru:
        jckpt.save_params(os.path.join("models", "bigru_00.00_dev.npz"),
                          jbuild("bigru", 5, defaults=True).init_params(
                              jax.random.PRNGKey(1)))
        names.append("bigru_00.00_dev")
    argv = ["--pretrained_model", *names, "--prob", "big", "--part", "test",
            "--data_dir", os.path.join(str(synthetic_root), "data"),
            "--annot_path", str(synthetic_root), "--models_dir",
            str(tmp_path / "models"), "--results_dir", "res",
            "--bucket_multiple", "32"]
    out = {}
    for who, cli, extra in (("jax", jcli, []),
                            ("port", pcli, ["--device", "cpu"])):
        (tmp_path / who).mkdir()
        monkeypatch.chdir(tmp_path / who)
        out[who] = (tmp_path / who / cli.main(argv + extra)).read_bytes()
    assert out["port"].startswith(b"Id,Category\n")
    assert out["port"] == out["jax"]
