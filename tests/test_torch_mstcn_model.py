"""The port's ms_tcn (``pytorch_video_action_tpu_torch/models/mstcn.py``,
its ``Trainer`` loss and its CLIs) against the JAX package's.

The port runs on the CPU, where each layer and each stage is its plain
PyTorch version; the JAX package runs its default XLA path.  Parameters
carry over with ``from_jax_params``; dropout seeds are the ones the JAX
forward derives from its PRNG key (``mstcn.py:164,144``): layer i of
stage s takes ``rng_seed_u32(split(split(rng, stages)[s], layers)[i])``,
passed to the port stage-major.  The JAX oracles are jitted: on the CPU
a compile of the model costs less than an eager first run, whose every
op compiles on its own.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_video_action_tpu.cli import inference_cli as jinfer
from pytorch_video_action_tpu.infer import loader as jloader
from pytorch_video_action_tpu.models import ModelDef
from pytorch_video_action_tpu.models import build_model as jbuild
from pytorch_video_action_tpu.models import mstcn as jmstcn
from pytorch_video_action_tpu.ops import hashmask as jhash
from pytorch_video_action_tpu.train import checkpoint as jckpt
from pytorch_video_action_tpu.train import losses as jlosses
from pytorch_video_action_tpu.train.loop import Trainer as JTrainer
from pytorch_video_action_tpu.train.loop import evaluate as jevaluate
from pytorch_video_action_tpu_torch.cli import inference_cli as pinfer
from pytorch_video_action_tpu_torch.cli import train_cli
from pytorch_video_action_tpu_torch.data import BatchFeed, VideoDataset
from pytorch_video_action_tpu_torch.infer import loader as ploader
from pytorch_video_action_tpu_torch.models import build_model
from pytorch_video_action_tpu_torch.models.mstcn import MSTCN, MSTCNConfig
from pytorch_video_action_tpu_torch.models.params import (from_jax_params,
                                                          to_jax_params)
from pytorch_video_action_tpu_torch.train import losses as plosses
from pytorch_video_action_tpu_torch.train.loop import Trainer, evaluate

SMALL = dict(dim=16, num_stages=2, num_layers=5, num_f_maps=64, n_class=7)
LR = 1e-3


def _port(cfg_kw, params):
    model = MSTCN(MSTCNConfig(**cfg_kw))
    model.load_state_dict(from_jax_params(
        "ms_tcn", jax.tree.map(np.asarray, params)))
    return model


def _inputs(seed, b, t, dim, lengths):
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int32)
    x = rng.normal(size=(b, t, dim)).astype(np.float32)
    x[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    return x, lengths


def _jax_seeds(rng, cfg):
    """The 80 (here stages * layers) seeds of one JAX train forward,
    stage-major."""
    seeds = []
    for r_stage in jax.random.split(rng, cfg.num_stages):
        seeds += [int(jhash.rng_seed_u32(r))
                  for r in jax.random.split(r_stage, cfg.num_layers)]
    return seeds


def test_eval_matches_jax_at_full_width():
    """The default config (400 -> 4 stages x 20 layers x 64 -> 48) at T=64:
    layers 6..19 of each stage collapse to the center tap.  The eval form
    runs the stages (no gradients) and the per-layer path (gradients on);
    logits to 1e-4 of their largest value (f32, 80 layers)."""
    cfg = jmstcn.MSTCNConfig()
    params = jmstcn.init(jax.random.PRNGKey(0), cfg)
    x, lengths = _inputs(0, 2, 64, 400, [64, 37])
    want = np.asarray(jax.jit(lambda p, a, b: jmstcn.apply(p, cfg, a, b))(
        params, jnp.asarray(x), jnp.asarray(lengths)))
    model = _port({}, params)
    xt, lt = torch.from_numpy(x), torch.from_numpy(lengths)
    with torch.no_grad():
        staged = model(xt, lt).numpy()
    per_layer = model(xt, lt).detach().numpy()
    tol = 1e-4 * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(staged, want, atol=tol, rtol=0)
    np.testing.assert_allclose(per_layer, want, atol=tol, rtol=0)
    assert not staged[1, 37:].any()


@jax.jit
def _jax_step(params, x, lengths, targets, key):
    """((cross-entropy loss, logits), gradients) of one train forward of
    the small config; one compile serves every test at B=3, T=24."""
    cfg = jmstcn.MSTCNConfig(**SMALL)

    def loss(p):
        out = jmstcn.apply(p, cfg, x, lengths, train=True, rng=key)
        return jlosses.cross_entropy_loss(out, targets), out

    return jax.value_and_grad(loss, has_aux=True)(params)


def _small_batch(seed):
    x, lengths = _inputs(seed, 3, 24, 16, [24, 13, 1])
    targets = np.random.default_rng(seed).integers(0, 7, (3, 24))
    targets[np.arange(24)[None, :] >= lengths[:, None]] = -1
    return x, lengths, targets.reshape(-1), None


def _jax_small_step(params, batch, key):
    x, lengths, targets, _ = batch
    (loss, out), grads = _jax_step(params, jnp.asarray(x),
                                   jnp.asarray(lengths),
                                   jnp.asarray(targets), key)
    return float(loss), np.asarray(out), {
        k: np.asarray(v) for k, v in jckpt._flatten(grads).items()}


def _assert_grads_close(model, want):
    for name, p in model.named_parameters():
        w = want[name.replace(".", "/")]
        assert np.abs(p.grad.numpy() - w).max() <= 1e-5 * max(
            1.0, np.abs(w).max()), name


def test_train_forward_and_loss_match_jax_with_its_seeds():
    cfg = jmstcn.MSTCNConfig(**SMALL)
    params = jmstcn.init(jax.random.PRNGKey(1), cfg)
    batch = _small_batch(1)
    x, lengths, targets, _ = batch
    key = jax.random.PRNGKey(5)
    want_loss, want, want_grads = _jax_small_step(params, batch, key)
    model = _port(SMALL, params)
    out = model(torch.from_numpy(x), torch.from_numpy(lengths), train=True,
                seeds=_jax_seeds(key, cfg))
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-5,
                               rtol=0)
    loss = plosses.cross_entropy_loss(out, torch.from_numpy(targets))
    loss.backward()
    assert abs(loss.item() - want_loss) <= 1e-5
    _assert_grads_close(model, want_grads)


def test_use_pallas_trains_on_the_jax_per_video_stream(monkeypatch):
    """``--use_pallas``: the JAX layer then draws one uint32 seed a video a
    layer, ``bits(rng, (B,))`` (``ops/conv.py:366-375``), for its Pallas
    kernel.  The JAX model runs here with that call replaced by the
    stream's XLA reference, ``conv_pallas.hash_dropout_reference`` (the
    function the kernel's VJP recomputes through), never the kernel; the
    port takes the same seeds, computed in JAX.  Logits, loss and every
    gradient to 1e-5."""
    from pytorch_video_action_tpu.ops import conv_pallas as jcp

    monkeypatch.setattr(
        jcp, "fused_dilated_residual",
        lambda layer, x, mask, dilation, dropout_rate=0.0, seeds=None:
        jcp.hash_dropout_reference(layer, x, mask, dilation, dropout_rate,
                                   seeds))
    cfg = jmstcn.MSTCNConfig(**SMALL, use_pallas=True)
    params = jmstcn.init(jax.random.PRNGKey(2), cfg)
    x, lengths, targets, _ = _small_batch(2)
    key = jax.random.PRNGKey(6)

    def jloss(p):
        out = jmstcn.apply(p, cfg, jnp.asarray(x), jnp.asarray(lengths),
                           train=True, rng=key)
        return jlosses.cross_entropy_loss(out, jnp.asarray(targets)), out

    (want_loss, want), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    seeds = [np.asarray(jax.random.bits(r, (3,), jnp.uint32)).tolist()
             for r_stage in jax.random.split(key, cfg.num_stages)
             for r in jax.random.split(r_stage, cfg.num_layers)]
    model = build_model("ms_tcn", 7, use_pallas=True, cfg_overrides={
        k: v for k, v in SMALL.items() if k != "n_class"})
    assert model.per_video_dropout and model.n_dropout_sites == 10
    model.load_state_dict(from_jax_params(
        "ms_tcn", jax.tree.map(np.asarray, params)))
    out = model(torch.from_numpy(x), torch.from_numpy(lengths), train=True,
                seeds=seeds)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    loss = plosses.cross_entropy_loss(out, torch.from_numpy(targets))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    _assert_grads_close(model, {k: np.asarray(v) for k, v in
                                jckpt._flatten(jgrads).items()})
    # the Trainer draws one seed a video for each of its layers
    tr = Trainer(model, 7, seed=0, device="cpu")
    drawn = tr.draw_seeds(tr.init_state(), 3)
    assert len(drawn) == 10 and all(len(s) == 3 for s in drawn)


def test_params_round_trip_and_checkpoints_load_both_ways(tmp_path):
    cfg = jmstcn.MSTCNConfig(**SMALL)
    params = jmstcn.init(jax.random.PRNGKey(2), cfg)
    model = _port(SMALL, params)
    back = to_jax_params("ms_tcn", model.state_dict())
    assert len(back["stages"]) == 2 and len(back["stages"][0]["layers"]) == 5
    want = {k: np.asarray(v) for k, v in jckpt._flatten(params).items()}
    got = jckpt._flatten(back)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    path = os.path.join(tmp_path, "mstcn_12.34_dev.npz")
    jckpt.save_params(path, params)
    from pytorch_video_action_tpu_torch.train import checkpoint as pckpt

    assert jckpt._flatten(pckpt.load_params(path)).keys() == want.keys()


def test_build_model_and_loss_selection():
    for name in ("ms_tcn", "mstcn"):
        model = build_model(name, 48, defaults=True)
        assert isinstance(model, MSTCN) and model.n_dropout_sites == 80
        assert plosses.make_loss_fn(name) is plosses.cross_entropy_loss
        assert (jlosses.make_loss_fn(name, 48)
                is jlosses.cross_entropy_loss)
    for name in ("bigru", "bilstm", "bilstm_lm", "attn", "win_attn"):
        assert plosses.make_loss_fn(name) is plosses.nll_loss
        assert build_model(name, 48).name == name
    # ctcloss (a BiGRU with the CTC blank as class n_class) takes CTC
    ctc = build_model("ctcloss", 48)
    assert ctc.name == "ctcloss" and ctc.cfg.n_class == 49
    fn = plosses.make_loss_fn("ctcloss", 48)
    lp = torch.log_softmax(torch.randn(2, 9, 49), -1)
    args = (torch.tensor([9, 5]), torch.tensor([[3, 7, 3], [1, 0, 0]]),
            torch.tensor([3, 1]))
    assert fn(lp, *args).item() == plosses.ctc_loss(lp, *args, 48).item()
    with pytest.raises(ValueError, match="n_class"):
        plosses.make_loss_fn("ctcloss")


def _jax_small():
    cfg = jmstcn.MSTCNConfig(**SMALL)
    return ModelDef("ms_tcn", cfg, lambda rng: jmstcn.init(rng, cfg),
                    lambda p, x, l, **kw: jmstcn.apply(p, cfg, x, l, **kw),
                    "logits")


def test_trainer_steps_equal_jax_trainer():
    """Three steps with dropout from the same parameters and the JAX step's
    seeds: cross-entropy loss, gradients (through the first step's
    parameters) and parameters."""
    mdef = _jax_small()
    jtr = JTrainer(mdef, SMALL["n_class"], lr=LR, seed=0)
    jts = jtr.init_state()
    model = _port(SMALL, jts.params)
    tr = Trainer(model, SMALL["n_class"], lr=LR, seed=0, device="cpu")
    ts = tr.init_state()
    for step in range(3):
        batch = _small_batch(10 + step)
        _, sub = jax.random.split(jts.rng)
        _, _, want_grads = _jax_small_step(jts.params, batch, sub)
        want_loss = float(jtr.train_step(jts, batch))
        loss = tr.train_step(ts, batch, seeds=_jax_seeds(sub,
                                                         mdef.config)).item()
        assert abs(loss - want_loss) <= 1e-5, step
        _assert_grads_close(ts.model, want_grads)
        want = {k: np.asarray(v) for k, v in jckpt._flatten(
            jts.params).items()}
        for name, p in ts.model.named_parameters():
            diff = np.abs(p.detach().numpy() - want[name.replace(".", "/")])
            # Adam's first steps are LR-sized; a near-zero gradient element
            # may flip sign between two correct f32 versions
            assert int((diff > 1e-4).sum()) <= max(1, diff.size // 1000)
            assert diff.max() <= 2.5 * LR, name


def _feeds(root):
    kw = dict(data_dir=os.path.join(str(root), "data"), annot_path=str(root),
              part="dev", split=0, mode="active", verbose=False)
    from pytorch_video_action_tpu.data import BatchFeed as JBatchFeed
    from pytorch_video_action_tpu.data import VideoDataset as JVideoDataset

    return (BatchFeed(VideoDataset(**kw), batch_size=2, bucket_multiple=32),
            JBatchFeed(JVideoDataset(**kw), batch_size=2, bucket_multiple=32))


def test_evaluate_equals_jax(synthetic_root, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    pfeed, jfeed = _feeds(synthetic_root)
    kw = dict(SMALL, dim=400, n_class=5)
    cfg = jmstcn.MSTCNConfig(**kw)
    mdef = ModelDef("ms_tcn", cfg, lambda rng: jmstcn.init(rng, cfg),
                    lambda p, x, l, **k: jmstcn.apply(p, cfg, x, l, **k),
                    "logits")
    params = mdef.init(jax.random.PRNGKey(3))
    assert evaluate(_port(kw, params), pfeed) == jevaluate(mdef, params,
                                                           jfeed)


def test_train_cli_checkpoint_scores_in_jax_and_serves_as_mstcn(
        synthetic_root, tmp_path, monkeypatch):
    """The train CLI writes ``ms_tcn_*_dev.npz``; JAX scores it to the
    accuracy the port printed; renamed ``mstcn_*`` it serves, and the
    test CSV is byte-identical to the JAX CLI's.  An ``ms_tcn_*`` name is
    skipped by both loaders."""
    monkeypatch.chdir(tmp_path)
    data = os.path.join(str(synthetic_root), "data")
    best = train_cli.main(["--model", "ms_tcn", "--device", "cpu",
                           "--epoch", "2", "--batchsize", "2",
                           "--bucket_multiple", "32", "--data_dir", data,
                           "--annot_path", str(synthetic_root)])
    name = f"ms_tcn_{best:.2f}_dev"
    assert os.path.exists(os.path.join("models", f"{name}.npz"))
    mdef = jbuild("ms_tcn", 5)
    params = jckpt.load_params(os.path.join("models", f"{name}.npz"))
    _, jfeed = _feeds(synthetic_root)
    assert jevaluate(mdef, params, jfeed)[0] == best

    assert ploader.load_models([name], 5, device="cpu") == {}
    assert jloader.load_models([name], 5) == {}
    served = f"mstcn_{best:.2f}_dev"
    shutil.copy(os.path.join("models", f"{name}.npz"),
                os.path.join("models", f"{served}.npz"))
    argv = ["--pretrained_model", served, "--prob", "big", "--part", "test",
            "--data_dir", data, "--annot_path", str(synthetic_root),
            "--bucket_multiple", "32"]
    want = open(jinfer.main(argv + ["--results_dir", "jres"]), "rb").read()
    got = open(pinfer.main(argv + ["--results_dir", "pres", "--device",
                                   "cpu"]), "rb").read()
    assert got.startswith(b"Id,Category\n") and got == want
