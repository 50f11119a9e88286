"""The port's bilstm and bilstm_lm (``pytorch_video_action_tpu_torch/
models/lstm.py``), their weight and BatchNorm-state carry-over,
checkpoints, ``Trainer`` steps, ``evaluate`` and CLIs against the JAX
package.

The port runs on the CPU, where the LSTM layer's forms and backward are
their plain PyTorch versions; the JAX package runs its XLA path (Pallas is
off on the CPU).  Inputs come from numpy seeds, parameters (and running
stats) carry over with ``from_jax_params``, and dropout seeds are the ones
the JAX step derives from its PRNG key.
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
from pytorch_video_action_tpu_torch.train import checkpoint as pckpt
from pytorch_video_action_tpu_torch.train.loop import Trainer, evaluate

# the train CLI's flags at a narrow width: H=16, linear 32 -> 16
NARROW = dict(lstm_layer=2, lstm_hidden1=32, lstm_hidden2=16)
N_CLASS = 7
LR = 1e-3


@pytest.fixture
def one_thread():
    # single-threaded reductions, as in test_torch_train.py: a near-zero
    # gradient element can otherwise flip the sign of the first Adam step
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name, seed=0, n_class=N_CLASS, **flags):
    """The JAX ModelDef with its initial params (and state), and the port
    model carrying the same values."""
    kw = dict(NARROW, **flags)
    mdef = jbuild(name, n_class, **kw)
    init = mdef.init(jax.random.PRNGKey(seed))
    params, state = init if mdef.stateful else (init, None)
    tree = jax.tree.map(np.asarray, params)
    st = None if state is None else jax.tree.map(np.asarray, state)
    model = build_model(name, n_class, **kw)
    model.load_state_dict(from_jax_params(name, tree, st))
    return mdef, params, state, model


def _batch(seed, b=3, t=24, n_class=N_CLASS, pred_mode="cont"):
    rng = np.random.default_rng(seed)
    lengths = np.array([t, t // 2 + 1, 1][:b], np.int32)
    x = rng.normal(size=(b, t, 400)).astype(np.float32)
    x[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    if pred_mode != "cont":
        return x, lengths, rng.integers(0, n_class, b), None
    targets = rng.integers(0, n_class, (b, t))
    targets[np.arange(t)[None, :] >= lengths[:, None]] = -1
    return x, lengths, targets.reshape(-1), None


def _jax_seeds(name, key, n_layers):
    """The dropout seeds of one JAX forward from ``key``: models/lstm.py
    splits it into input, RNN (and, for bilstm, mid) keys, rnn.py:522
    splits the RNN key once per inter-layer site."""
    keys = jax.random.split(key, 3 if name == "bilstm" else 2)
    seeds = [int(jhash.rng_seed_u32(keys[0]))]
    r_rnn = keys[1]
    for _ in range(n_layers - 1):
        r_rnn, sub = jax.random.split(r_rnn)
        seeds.append(int(jhash.rng_seed_u32(sub)))
    if name == "bilstm":
        seeds.append(int(jhash.rng_seed_u32(keys[2])))
    return seeds


def _valid(lengths, t):
    return np.arange(t)[None, :] < lengths[:, None]


# ------------------------------------------------------------------ models


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("mode", ["cont", "last", "avg"])
def test_bilstm_logprobs_match_jax(mode, train):
    """Eval form, and train form with the JAX dropout seeds handed over
    (input, inter-layer and mid dropout)."""
    mdef, params, _, model = _pair("bilstm", seed=1, pred_mode=mode)
    x, lengths, _, _ = _batch(1, t=30)
    key = jax.random.PRNGKey(5) if train else None
    want = np.asarray(jax.jit(
        lambda p, xx, ln: mdef.apply(p, xx, ln, train=train, rng=key))(
            params, jnp.asarray(x), jnp.asarray(lengths)))
    seeds = _jax_seeds("bilstm", key, 2) if train else None
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(lengths),
                    train=train, seeds=seeds).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if mode == "cont":
        m = _valid(lengths, 30)
        got, want = got[m], want[m]
    # f32, the same sums in another order
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_bilstm_lm_matches_jax_and_updates_its_stats():
    """A train forward (dropout on, batch statistics over valid frames,
    the running stats updated) and then the eval form with those stats."""
    mdef, params, state, model = _pair("bilstm_lm", seed=2)
    x, lengths, _, _ = _batch(2, t=30)
    key = jax.random.PRNGKey(6)
    apply = jax.jit(mdef.apply, static_argnames="train")
    want, new_state = apply(params, jnp.asarray(x), jnp.asarray(lengths),
                            train=True, rng=key, state=state)
    got = model(torch.from_numpy(x), torch.from_numpy(lengths), train=True,
                seeds=_jax_seeds("bilstm_lm", key, 2)).detach().numpy()
    # the context scan feeds log-probs back, so f32 differences grow with
    # the magnitudes: relative to the largest (at least 1)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - np.asarray(want)).max() <= 1e-5 * scale
    assert np.all(got[~_valid(lengths, 30)] == 0.0)
    for bn in ("bn1", "bn2"):
        for stat in ("mean", "var"):
            buf = getattr(getattr(model, bn), stat)
            assert buf.dtype == torch.float32
            np.testing.assert_allclose(buf.numpy(), new_state[bn][stat],
                                       atol=1e-6, rtol=1e-6)
    want, _ = apply(params, jnp.asarray(x), jnp.asarray(lengths),
                    train=False, state=new_state)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - np.asarray(want)).max() <= 1e-5 * scale


@pytest.mark.parametrize("name,flags", [
    ("bilstm", dict(defaults=True)),
    ("bilstm", dict(pred_mode="avg", lstm_layer=3, lstm_dropout=0.2,
                    lstm_hidden1=64, lstm_hidden2=8)),
    ("bilstm_lm", dict(lstm_layer=1, lstm_dropout=0.0, lstm_hidden1=64,
                       lstm_hidden2=8)),
    ("bilstm_lm", dict(defaults=True))])
def test_build_model_follows_the_jax_factory(name, flags):
    """The same configuration, parameter shapes, state and dropout sites
    as the JAX package's build_model for the same flags."""
    mdef = jbuild(name, 48, **flags)
    model = build_model(name, 48, **flags)
    assert dataclasses.asdict(model.cfg) == dataclasses.asdict(mdef.config)
    assert model.stateful == mdef.stateful
    init = mdef.init(jax.random.PRNGKey(0))
    params, state = init if mdef.stateful else (init, {})
    want = {**jckpt._flatten(params), **jckpt._flatten(state)}
    got = {k.replace(".", "/"): tuple(v.shape)
           for k, v in model.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in want.items()}
    sites = mdef.config.lstm_layer + (1 if name == "bilstm" else 0)
    assert model.n_dropout_sites == sites


@pytest.mark.parametrize("name", ["bilstm", "bilstm_lm"])
def test_train_forward_needs_seeds(name):
    model = build_model(name, N_CLASS, **NARROW)
    with pytest.raises(ValueError, match="seeds"):
        model(torch.zeros(1, 4, 400), torch.tensor([4]), train=True)


def test_params_and_state_round_trip():
    _, params, state, model = _pair("bilstm_lm", seed=3)
    got_p, got_s = to_jax_params("bilstm_lm", model.state_dict(),
                                 with_state=True)
    for got, want in ((got_p, params), (got_s, state)):
        a, b = jckpt._flatten(got), jckpt._flatten(want)
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], np.asarray(b[k])), k
    assert to_jax_params("bilstm", build_model(
        "bilstm", N_CLASS).state_dict(), with_state=True)[1] is None


def test_stateful_checkpoints_load_in_either_package(tmp_path):
    """bilstm_lm's running stats go under ``__state__/``: written by the
    port and read by JAX, written by JAX and read by the port, and a
    checkpoint without state leaves the port model's initial stats."""
    _, params, state, model = _pair("bilstm_lm", seed=4)
    with torch.no_grad():
        model.bn1.mean.add_(0.5)  # stats that differ from the initial ones
    p_tree, s_tree = to_jax_params("bilstm_lm", model.state_dict(),
                                   with_state=True)
    path = str(tmp_path / "bilstm_lm_12.34_dev")
    pckpt.save_params(path, p_tree, s_tree)
    jp, js = jckpt.load_params(path + ".npz", with_state=True)
    for got, want in ((jp, p_tree), (js, s_tree)):
        a, b = jckpt._flatten(got), jckpt._flatten(want)
        assert a.keys() == b.keys()
        assert all(np.array_equal(np.asarray(a[k]), b[k]) for k in a)

    jpath = str(tmp_path / "j.npz")
    jckpt.save_params(jpath, jp, js)
    back = build_model("bilstm_lm", N_CLASS, **NARROW)
    load_jax_params(back, "bilstm_lm", *pckpt.load_params(jpath,
                                                          with_state=True))
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k

    jckpt.save_params(jpath, jp)  # params only
    fresh = build_model("bilstm_lm", N_CLASS, **NARROW)
    load_jax_params(fresh, "bilstm_lm", *pckpt.load_params(jpath,
                                                           with_state=True))
    assert torch.equal(fresh.bn1.mean, torch.zeros(32))
    assert torch.equal(fresh.bn1.var, torch.ones(32))
    with pytest.raises(RuntimeError):  # bilstm_lm's params into a bilstm
        load_jax_params(build_model("bilstm", N_CLASS, **NARROW), "bilstm",
                        jp)


# ---------------------------------------------------------------- trainer


def _flat(tree):
    return {k: np.asarray(v) for k, v in jckpt._flatten(tree).items()}


def _assert_params_close(model, params, state):
    """Adam steps are LR-sized; on elements whose true gradient is near 0
    the first step's sign can flip between two correct f32 versions
    (test_train_step_parity.py): at most 1 in 1000 elements beyond 1e-4,
    none beyond 2.5 LR.  Running stats to 1e-5."""
    want = _flat(params)
    got = {k.replace(".", "/"): v.detach().numpy()
           for k, v in model.named_parameters()}
    assert got.keys() == want.keys()
    for k in want:
        diff = np.abs(got[k].astype(np.float64) - want[k])
        assert int((diff > 1e-4).sum()) <= max(1, diff.size // 1000), k
        assert diff.max() <= 2.5 * LR, k
    if state is not None:
        for k, v in _flat(state).items():
            buf = model.state_dict()[k.replace("/", ".")]
            np.testing.assert_allclose(buf.numpy(), v, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["bilstm", "bilstm_lm"])
def test_trainer_steps_equal_jax_trainer(one_thread, name):
    """Three steps with dropout on, from the same parameters and with the
    JAX step's seeds: loss, gradients, parameters and, for bilstm_lm, the
    running stats."""
    mdef, _, _, model = _pair(name)
    jtr = JTrainer(mdef, N_CLASS, lr=LR, seed=0)
    jts = jtr.init_state()
    tr = Trainer(model, N_CLASS, lr=LR, seed=0, device="cpu")
    ts = tr.init_state()

    @jax.jit
    def jloss_grad(p, ms, x, lengths, targets, key):
        def jloss(q):
            if mdef.stateful:
                out, _ = mdef.apply(q, x, lengths, train=True, rng=key,
                                    state=ms)
            else:
                out = mdef.apply(q, x, lengths, train=True, rng=key)
            return jlosses.nll_loss(out.astype(jnp.float32), targets)
        return jax.value_and_grad(jloss)(p)

    for step in range(3):
        batch = _batch(10 + step)
        x, lengths, targets, _ = batch
        _, sub = jax.random.split(jts.rng)
        seeds = _jax_seeds(name, sub, NARROW["lstm_layer"])
        want_loss, want_grads = jloss_grad(
            jts.params, jts.model_state, jnp.asarray(x), jnp.asarray(lengths),
            jnp.asarray(targets), sub)
        want_grads = _flat(want_grads)
        jtr.train_step(jts, batch)
        loss = tr.train_step(ts, batch, seeds=seeds)
        # f32, the same sums in another order
        assert abs(loss.item() - float(want_loss)) <= 1e-5 * max(
            1.0, abs(float(want_loss)))
        for pname, p in ts.model.named_parameters():
            w = want_grads[pname.replace(".", "/")]
            g = p.grad.numpy()
            assert np.abs(g - w).max() <= 1e-5 * max(1.0, np.abs(w).max()), \
                (step, pname)
        _assert_params_close(ts.model, jts.params, jts.model_state)


def test_bf16_step_keeps_running_stats_f32():
    """Under bf16 the parameters are cast for the forward and the running
    stats are not: they stay f32 and move as the f32 step moves them, to
    bf16's 8 bits (the statistics of a bf16 stream)."""
    stats = {}
    for dt in ("float32", "bfloat16"):
        model = build_model("bilstm_lm", N_CLASS, **NARROW,
                            generator=torch.Generator().manual_seed(1))
        tr = Trainer(model, N_CLASS, lr=LR, seed=0, compute_dtype=dt,
                     device="cpu")
        ts = tr.init_state()
        tr.train_step(ts, _batch(1), seeds=[1, 2])
        stats[dt] = {k: v.clone() for k, v in ts.model.named_buffers()}
        for k, v in stats[dt].items():
            assert v.dtype == torch.float32, k
    for k, want in stats["float32"].items():
        got = stats["bfloat16"][k]
        if k.endswith("mean"):
            assert want.abs().max().item() > 0.0, k  # the step moved it
        assert (got - want).abs().max().item() <= 2e-2 * max(
            1.0, want.abs().max().item()), k


def _dev_feeds(root, batch=2, bucket=32):
    kw = dict(data_dir=os.path.join(str(root), "data"),
              annot_path=str(root), part="dev", split=0, mode="active")
    return (BatchFeed(VideoDataset(verbose=False, **kw), batch_size=batch,
                      bucket_multiple=bucket),
            JBatchFeed(JVideoDataset(verbose=False, **kw), batch_size=batch,
                       bucket_multiple=bucket))


@pytest.mark.parametrize("name", ["bilstm", "bilstm_lm"])
def test_evaluate_equals_jax(synthetic_root, tmp_path, monkeypatch, name):
    monkeypatch.chdir(tmp_path)
    pfeed, jfeed = _dev_feeds(synthetic_root)
    mdef, params, state, model = _pair(name, seed=3, n_class=5)
    assert evaluate(model, pfeed) == jevaluate(mdef, params, jfeed, state)


# -------------------------------------------------------------------- CLI


@pytest.mark.parametrize("name", ["bilstm", "bilstm_lm"])
def test_train_cli_end_to_end(synthetic_root, tmp_path, monkeypatch, name):
    """Train at full width on the synthetic tree; the JAX package scores
    the checkpoint (with its running stats, for bilstm_lm) to the dev
    accuracy the port printed."""
    monkeypatch.chdir(tmp_path)
    best = train_cli.main([
        "--model", name, "--device", "cpu", "--epoch", "2", "--batchsize",
        "2", "--bucket_multiple", "32", "--data_dir",
        os.path.join(str(synthetic_root), "data"), "--annot_path",
        str(synthetic_root)])
    path = os.path.join("models", f"{name}_{best:.2f}_dev.npz")
    params, state = jckpt.load_params(path, with_state=True)
    assert (state is not None) == (name == "bilstm_lm")
    _, jfeed = _dev_feeds(synthetic_root)
    seg_acc, _ = jevaluate(jbuild(name, 5), params, jfeed, state)
    assert seg_acc == best


@pytest.fixture(scope="module")
def models_dir(synthetic_root, tmp_path_factory):
    """Full-width bilstm and bigru checkpoints from seeded weights, written
    by the JAX package."""
    d = tmp_path_factory.mktemp("torch_lstm_models")
    for name in ("bilstm", "bigru"):
        mdef = jbuild(name, 5, defaults=True)
        jckpt.save_params(os.path.join(d, f"{name}_00.00_dev.npz"),
                          mdef.init_params(jax.random.PRNGKey(1)))
    return str(d)


@pytest.mark.parametrize("names", [["bilstm_00.00_dev"],
                                   ["bilstm_00.00_dev", "bigru_00.00_dev"]])
def test_test_csv_byte_identical_to_jax(synthetic_root, models_dir, tmp_path,
                                        monkeypatch, names):
    """A bilstm checkpoint served alone and in an ensemble with a bigru
    one: the port's CSV is the JAX CLI's, byte for byte."""
    argv = ["--pretrained_model", *names, "--prob", "big", "--part", "test",
            "--data_dir", os.path.join(str(synthetic_root), "data"),
            "--annot_path", str(synthetic_root), "--models_dir", models_dir,
            "--results_dir", "res", "--bucket_multiple", "32"]
    out = {}
    for who, cli, extra in (("jax", jcli, []),
                            ("port", pcli, ["--device", "cpu"])):
        (tmp_path / who).mkdir()
        monkeypatch.chdir(tmp_path / who)
        out[who] = (tmp_path / who / cli.main(argv + extra)).read_bytes()
    assert out["port"].startswith(b"Id,Category\n")
    assert out["port"] == out["jax"]


def test_bilstm_lm_is_not_served_by_the_inference_cli(tmp_path):
    from pytorch_video_action_tpu_torch.infer import loader

    assert loader.load_models(["bilstm_lm_50.00_dev"], 48,
                              models_dir=str(tmp_path), device="cpu") == {}
