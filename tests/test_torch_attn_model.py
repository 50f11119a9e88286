"""The port's attn and win_attn (``pytorch_video_action_tpu_torch/models/
attention.py``), their weight carry-over, ``Trainer`` steps and CLIs
against the JAX package.

The port runs on the CPU, where the flash kernels and the GRU layer's are
their plain PyTorch versions; the JAX package runs its XLA path (Pallas is
off on the CPU).  ``BLOCKWISE_MIN_T`` is lowered on both sides where a test
drives the flash path at a small T.  Inputs come from numpy seeds,
parameters carry over with ``from_jax_params``, and the dropout seed is
the one the JAX forward derives from its PRNG key.  f32: 1e-5 of each
tensor's largest element (at least 1), the same sums in another order.
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
from pytorch_video_action_tpu.models import attention as JA
from pytorch_video_action_tpu.models import build_model as jbuild
from pytorch_video_action_tpu.ops import hashmask as jhash
from pytorch_video_action_tpu.train import checkpoint as jckpt
from pytorch_video_action_tpu.train import losses as jlosses
from pytorch_video_action_tpu.train.loop import Trainer as JTrainer
from pytorch_video_action_tpu.train.loop import evaluate as jevaluate
from pytorch_video_action_tpu_torch.cli import inference_cli as pcli
from pytorch_video_action_tpu_torch.cli import train_cli
from pytorch_video_action_tpu_torch.models import attention as PA
from pytorch_video_action_tpu_torch.models import build_model
from pytorch_video_action_tpu_torch.models.params import (from_jax_params,
                                                          to_jax_params)
from pytorch_video_action_tpu_torch.ops import flash as F
from pytorch_video_action_tpu_torch.train.loop import Trainer

N_CLASS = 7
LR = 1e-3
TOL = 1e-5


@pytest.fixture
def one_thread():
    # single-threaded reductions, as in test_torch_train.py: a near-zero
    # gradient element can otherwise flip the sign of the first Adam step
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def min_t(monkeypatch):
    """Set ``BLOCKWISE_MIN_T`` of both packages."""
    def set_to(value):
        monkeypatch.setattr(JA, "BLOCKWISE_MIN_T", value)
        monkeypatch.setattr(PA, "BLOCKWISE_MIN_T", value)
    return set_to


def _pair(name, seed=0, n_class=N_CLASS, **flags):
    """The JAX ModelDef with its initial params, and the port model
    carrying the same values."""
    mdef = jbuild(name, n_class, **flags)
    params = mdef.init(jax.random.PRNGKey(seed))
    model = build_model(name, n_class, **flags)
    model.load_state_dict(from_jax_params(name, jax.tree.map(np.asarray,
                                                             params)))
    return mdef, params, model


def _batch(seed, b=3, t=40, n_class=N_CLASS, pred_mode="cont",
           lengths=None):
    rng = np.random.default_rng(seed)
    lengths = np.array(lengths or [t, t // 2 + 1, 1][:b], np.int32)
    x = rng.normal(size=(b, t, 400)).astype(np.float32)
    x[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    if pred_mode != "cont":
        return x, lengths, rng.integers(0, n_class, b), None
    targets = rng.integers(0, n_class, (b, t))
    targets[np.arange(t)[None, :] >= lengths[:, None]] = -1
    return x, lengths, targets.reshape(-1), None


def _seed(name, key):
    """The attention site's dropout seed of one JAX forward from ``key``:
    apply_attn splits it into attention and RNN keys; apply_win_attn hands
    it to the attention as it is."""
    if name == "attn":
        key = jax.random.split(key, 2)[0]
    return int(jhash.rng_seed_u32(key))


def _flat(tree):
    return {k: np.asarray(v) for k, v in jckpt._flatten(tree).items()}


def _close(got, want, what, tol=TOL):
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= tol, (what, err)


def _forward_and_grads(name, mdef, params, model, x, lengths, key, cot):
    """Log-probs and the gradients of ``sum(out * cot)`` in both
    packages: ``(got, want, got_grads, want_grads)``."""
    train = key is not None

    def jf(p):
        out = mdef.apply(p, jnp.asarray(x), jnp.asarray(lengths),
                         train=train, rng=key)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jf, has_aux=True))(params)
    out = model(torch.from_numpy(x), torch.from_numpy(lengths), train=train,
                seeds=[_seed(name, key)] if train else None)
    if out.requires_grad:  # win_attn with no window depends on no weight
        (out * torch.from_numpy(cot)).sum().backward()
    # a weight that does not reach the output (win_attn's combine_output)
    # gets no gradient, JAX's a zero one
    grads = {k.replace(".", "/"): (np.zeros(p.shape, np.float32)
                                   if p.grad is None else p.grad.numpy())
             for k, p in model.named_parameters()}
    return out.detach().numpy(), np.asarray(want), grads, _flat(jgrads)


# ------------------------------------------------------------------ models


@pytest.mark.parametrize("mode,path,train", [
    ("cont", "flash", True), ("cont", "flash", False), ("last", "flash", True),
    ("avg", "flash", True), ("cont", "dense", True), ("avg", "dense", False)])
def test_attn_matches_jax(min_t, mode, path, train):
    """Log-probs and gradients, eval form and train form (the attention
    dropout on, with the JAX seed), on the flash path (padded T = 150 >=
    the lowered BLOCKWISE_MIN_T) and on the dense one."""
    min_t(128 if path == "flash" else 1024)
    mdef, params, model = _pair("attn", seed=1, pred_mode=mode)
    flash_before = F.flash_fwd.launches
    x, lengths, _, _ = _batch(1, t=150)
    key = jax.random.PRNGKey(5) if train else None
    cot_shape = (3, 150, N_CLASS) if mode == "cont" else (3, N_CLASS)
    cot = np.random.default_rng(2).normal(size=cot_shape).astype(np.float32)
    if mode == "cont":  # padded frames' log-probs are discarded downstream
        cot[np.arange(150)[None, :] >= lengths[:, None]] = 0.0
    got, want, grads, jgrads = _forward_and_grads(
        "attn", mdef, params, model, x, lengths, key, cot)
    assert got.dtype == np.float32 and got.shape == want.shape
    if mode == "cont":
        valid = np.arange(150)[None, :] < lengths[:, None]
        got, want = got[valid], want[valid]
    _close(got, want, "log-probs")
    assert grads.keys() == jgrads.keys()
    for k in jgrads:
        _close(grads[k], jgrads[k], k)
    assert F.flash_fwd.launches == flash_before  # CPU: the plain version


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("t,lengths", [(23, [23, 23]), (64, [61, 17]),
                                       (4, [4, 2])])
def test_win_attn_matches_jax(t, lengths, train):
    """The JAX parity shape (T=23), a bucket-padded batch with ragged
    lengths, and T shorter than one stride (no window: all-zero scores)."""
    mdef, params, model = _pair("win_attn", seed=2, attn_head=4)
    x, lens, _, _ = _batch(3, b=2, t=t, lengths=lengths)
    key = jax.random.PRNGKey(6) if train else None
    cot = np.random.default_rng(3).normal(size=(2, t, N_CLASS)).astype(
        np.float32)
    got, want, grads, jgrads = _forward_and_grads(
        "win_attn", mdef, params, model, x, lens, key, cot)
    _close(got, want, "log-probs")
    for k in jgrads:
        _close(grads[k], jgrads[k], k)


@pytest.mark.parametrize("train", [False, True])
def test_win_attn_without_padding_mask_matches_jax(train):
    """``cfg_overrides={"mask_padding": False}`` in both packages (JAX's
    parity-test hook, ``models/__init__.py:62-73``): the windows attend
    the zero-pad tail and the batch padding, as the reference does.  A
    bucket-padded batch with ragged lengths, where that changes the
    scores."""
    flags = dict(attn_head=4, cfg_overrides={"mask_padding": False})
    mdef, params, model = _pair("win_attn", seed=2, **flags)
    assert not model.cfg.mask_padding
    x, lens, _, _ = _batch(3, b=2, t=64, lengths=[61, 17])
    key = jax.random.PRNGKey(6) if train else None
    cot = np.random.default_rng(3).normal(size=(2, 64, N_CLASS)).astype(
        np.float32)
    got, want, grads, jgrads = _forward_and_grads(
        "win_attn", mdef, params, model, x, lens, key, cot)
    _close(got, want, "log-probs")
    for k in jgrads:
        _close(grads[k], jgrads[k], k)
    masked = build_model("win_attn", N_CLASS, attn_head=4)
    masked.load_state_dict(model.state_dict())
    with torch.no_grad():
        other = masked(torch.from_numpy(x), torch.from_numpy(lens)).numpy()
    assert np.abs(other - got).max() > 1e-3  # the mask matters here


@pytest.mark.parametrize("name,flags", [
    ("attn", dict(defaults=True, attn_head=5, pred_mode="avg")),
    ("attn", dict(attn_head=5, pred_mode="last")),
    ("win_attn", dict(attn_head=8)),
    ("win_attn", dict(defaults=True, attn_head=2))])
def test_build_model_follows_the_jax_factory(name, flags):
    """The same configuration, parameter shapes and one dropout site as the
    JAX package's build_model for the same flags; the defaults (the
    inference contract) keep attn at 4 heads, as in JAX."""
    mdef = jbuild(name, 48, **flags)
    model = build_model(name, 48, **flags)
    got_cfg = dataclasses.asdict(model.cfg)
    want_cfg = dataclasses.asdict(mdef.config)
    assert got_cfg == want_cfg  # win_attn's mask_padding included
    assert not model.stateful and model.n_dropout_sites == 1
    want = _flat(mdef.init(jax.random.PRNGKey(0)))
    got = {k.replace(".", "/"): tuple(v.shape)
           for k, v in model.state_dict().items()}
    assert got == {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("name", ["attn", "win_attn"])
def test_params_round_trip(name):
    _, params, model = _pair(name, seed=3)
    got = _flat(to_jax_params(name, model.state_dict()))
    want = _flat(params)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    back = build_model(name, N_CLASS)
    back.load_state_dict(from_jax_params(name, to_jax_params(
        name, model.state_dict())))
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


@pytest.mark.parametrize("name", ["attn", "win_attn"])
def test_train_forward_needs_a_seed(name):
    model = build_model(name, N_CLASS)
    with pytest.raises(ValueError, match="seeds"):
        model(torch.zeros(1, 12, 400), torch.tensor([12]), train=True)


# ---------------------------------------------------------------- trainer


def _assert_params_close(model, params):
    """Adam steps are LR-sized; on elements whose true gradient is near 0
    the first step's sign can flip between two correct f32 versions
    (test_train_step_parity.py): at most 1 in 1000 elements beyond 1e-4,
    none beyond 2.5 LR."""
    want = _flat(params)
    got = {k.replace(".", "/"): v.detach().numpy()
           for k, v in model.named_parameters()}
    assert got.keys() == want.keys()
    for k in want:
        diff = np.abs(got[k].astype(np.float64) - want[k])
        assert int((diff > 1e-4).sum()) <= max(1, diff.size // 1000), k
        assert diff.max() <= 2.5 * LR, k


@pytest.mark.parametrize("name", ["attn", "win_attn"])
def test_trainer_steps_equal_jax_trainer(one_thread, min_t, name):
    """Three steps with dropout on, from the same parameters and with the
    JAX step's seed: loss, gradients and parameters.  attn runs its flash
    path (BLOCKWISE_MIN_T lowered to 64; padded T = 96)."""
    min_t(64)
    mdef, _, model = _pair(name)
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
        batch = _batch(10 + step, t=96)
        x, lengths, targets, _ = batch
        _, sub = jax.random.split(jts.rng)
        want_loss, want_grads = jloss_grad(
            jts.params, jnp.asarray(x), jnp.asarray(lengths),
            jnp.asarray(targets), sub)
        want_grads = _flat(want_grads)
        jtr.train_step(jts, batch)
        loss = tr.train_step(ts, batch, seeds=[_seed(name, sub)])
        assert abs(loss.item() - float(want_loss)) <= TOL * max(
            1.0, abs(float(want_loss)))
        for pname, p in ts.model.named_parameters():
            want = want_grads[pname.replace(".", "/")]
            if p.grad is None:  # win_attn's unused combine_output
                assert not want.any(), pname
                continue
            _close(p.grad.numpy(), want, (step, pname))
        _assert_params_close(ts.model, jts.params)


def test_bf16_step_keeps_f32_masters(min_t):
    """Under bf16 the attention's q/k/v and products are bf16 and its
    softmax state f32; the loss stays within 1e-2 relative of the f32
    step's from the same parameters and seed, on the flash path."""
    min_t(32)
    losses = {}
    for dt in ("float32", "bfloat16"):
        model = build_model("attn", N_CLASS,
                            generator=torch.Generator().manual_seed(1))
        tr = Trainer(model, N_CLASS, lr=LR, seed=0, compute_dtype=dt,
                     device="cpu")
        ts = tr.init_state()
        losses[dt] = tr.train_step(ts, _batch(1), seeds=[9]).item()
        for name, p in ts.model.named_parameters():
            assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    assert abs(losses["bfloat16"] - losses["float32"]) <= \
        1e-2 * abs(losses["float32"])


# -------------------------------------------------------------------- CLI


def _dev_feed(root, batch=2, bucket=32):
    kw = dict(data_dir=os.path.join(str(root), "data"),
              annot_path=str(root), part="dev", split=0, mode="active")
    return JBatchFeed(JVideoDataset(verbose=False, **kw), batch_size=batch,
                      bucket_multiple=bucket)


def _train_argv(root, name, *extra):
    return ["--model", name, "--device", "cpu", "--epoch", "2",
            "--batchsize", "2", "--bucket_multiple", "32", "--attn_head", "4",
            "--data_dir", os.path.join(str(root), "data"), "--annot_path",
            str(root), *extra]


def test_train_cli_end_to_end(synthetic_root, tmp_path, monkeypatch, min_t):
    """Train attn at full width on the synthetic tree (partly on the flash
    path: BLOCKWISE_MIN_T lowered to 64); the JAX package scores the
    checkpoint to the dev accuracy the port printed."""
    min_t(64)
    monkeypatch.chdir(tmp_path)
    before = F.flash_fwd.launches
    best = train_cli.main(_train_argv(synthetic_root, "attn"))
    assert F.flash_fwd.launches == before  # CPU: the plain version
    params = jckpt.load_params(os.path.join("models",
                                            f"attn_{best:.2f}_dev.npz"))
    seg_acc, _ = jevaluate(jbuild("attn", 5), params,
                           _dev_feed(synthetic_root))
    assert seg_acc == best


def test_win_attn_train_cli_and_evaluate(synthetic_root, tmp_path,
                                         monkeypatch):
    """win_attn trains through the CLI (finite losses; it scores only every
    fifth frame, so on this tree its segment accuracy stays 0 and no
    checkpoint is written, as in JAX), and ``evaluate`` of a seeded model
    equals the JAX one."""
    import json

    from pytorch_video_action_tpu_torch.data import BatchFeed, VideoDataset
    from pytorch_video_action_tpu_torch.train.loop import evaluate

    monkeypatch.chdir(tmp_path)
    train_cli.main(_train_argv(synthetic_root, "win_attn", "--metrics_jsonl",
                               "m.jsonl"))
    losses = [r["train_loss"] for r in map(json.loads, open("m.jsonl"))
              if r["event"] == "epoch"]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    mdef, params, model = _pair("win_attn", seed=4, n_class=5)
    kw = dict(data_dir=os.path.join(str(synthetic_root), "data"),
              annot_path=str(synthetic_root), part="dev", split=0,
              mode="active")
    pfeed = BatchFeed(VideoDataset(verbose=False, **kw), batch_size=2,
                      bucket_multiple=32)
    assert evaluate(model, pfeed) == jevaluate(mdef, params,
                                               _dev_feed(synthetic_root))


@pytest.fixture(scope="module")
def models_dir(synthetic_root, tmp_path_factory):
    """A full-width attn checkpoint from seeded weights, JAX-written."""
    d = tmp_path_factory.mktemp("torch_attn_models")
    mdef = jbuild("attn", 5, defaults=True)
    jckpt.save_params(os.path.join(d, "attn_00.00_dev.npz"),
                      mdef.init_params(jax.random.PRNGKey(2)))
    return str(d)


@pytest.mark.parametrize("blockwise_min_t", [1024, 64])
def test_test_csv_byte_identical_to_jax(synthetic_root, models_dir, tmp_path,
                                        monkeypatch, min_t, blockwise_min_t):
    """An attn checkpoint served by both CLIs: the port's CSV is the JAX
    CLI's, byte for byte, on the dense path and with the longer buckets on
    the flash path."""
    min_t(blockwise_min_t)
    argv = ["--pretrained_model", "attn_00.00_dev", "--prob", "big",
            "--part", "test", "--attn_head", "4",
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
