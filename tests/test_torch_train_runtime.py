"""The port's training runtime against the JAX package, on the CPU.

At tiny fp32 configs (T=4, S=16, d_model 32, 2 heads, factored 2 x 8
vocabulary): the parameter and FLOP counts; the model exports
(`params.msgpack` in both layer layouts, `model.safetensors`) read by the
JAX package's loaders and by the port's own, which needs no `msgpack`
package; the full-state `Checkpointer` mid-accumulation and the trajectory
after a resume; the trainer CLI end to end; the trainer's loop against the
JAX trainer on the same data, weights and corruption draws; remat under
every policy; dropout; the prefetcher and the profiling helpers.
Tolerances are stated at each test.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from test_torch_train import jax_noise, random_tree
from tpu1x.model_zoo import genie_tiny as jax_tiny
from tpu1x.models.st_maskgit import STMaskGIT as JaxModel
from tpu1x.models.st_maskgit import count_params as jax_count_params
from tpu1x.models.st_maskgit import \
    flops_per_update_step as jax_flops_per_update_step
from tpu1x.ops.attention import mha_reference as jax_mha
from tpu1x.train import checkpoint as jax_ckpt
from tpu1x_torch import kernels
from tpu1x_torch.data.corruption import draw_noise, maskgit_corrupt
from tpu1x_torch.data.token_store import write_token_dataset
from tpu1x_torch.model_zoo import genie_tiny
from tpu1x_torch.models import st_transformer
from tpu1x_torch.models.st_maskgit import (STMaskGIT, count_params,
                                           flops_per_update_step)
from tpu1x_torch.train import _msgpack
from tpu1x_torch.train import checkpoint as ckpt
from tpu1x_torch.train.optim import TrainOptimizer
from tpu1x_torch.train.prefetch import DevicePrefetcher
from tpu1x_torch.train.step import make_train_step
from tpu1x_torch.utils import profiling
from tpu1x_torch.weights import params_from_jax, params_to_jax

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
SIZE = dict(T=4, num_prompt_frames=2, num_heads=2, d_model=32)


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors take the plain versions: no kernel is ever counted."""
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


def jax_setup(seed=0, **kw):
    """(jax config, port config, numpy flax tree) from one seed."""
    jcfg = jax_tiny(**SIZE, remat=False, **kw)
    cfg = genie_tiny(**SIZE, **kw)
    dummy = jnp.zeros((1, jcfg.T * jcfg.S), jnp.int32)
    act = (jnp.zeros((1, jcfg.T), jnp.int32)
           if jcfg.action_vocab_size else None)
    tree = JaxModel(jcfg).init(jax.random.PRNGKey(0), dummy, dummy,
                               act)["params"]
    return jcfg, cfg, random_tree(jax.device_get(tree), seed)


def port_model(cfg, tree):
    model = STMaskGIT(cfg)
    model.load_state_dict(params_from_jax(tree, cfg))
    return model


def ids(cfg, seed, batch=2):
    return np.random.default_rng(seed).integers(
        0, cfg.image_vocab_size, (batch, cfg.T * cfg.S)).astype(np.int32)


# ------------------------------------------------------------------ counts

@pytest.mark.parametrize("kw", [dict(), dict(qk_norm=True, qkv_bias=True),
                                dict(action_vocab_size=5)],
                         ids=["default", "qk_norm-bias", "actions"])
def test_count_params_and_flops(kw):
    """Exactly the JAX package's counts for the same model."""
    jcfg, cfg, tree = jax_setup(**kw)
    n = count_params(STMaskGIT(cfg))
    assert n == jax_count_params(tree)
    assert n == count_params(STMaskGIT(cfg).state_dict())
    tokens = 8 * cfg.T * cfg.S
    assert flops_per_update_step(n, tokens) == \
        jax_flops_per_update_step(n, tokens)
    assert profiling.training_flops(n, tokens) == 6 * n * tokens
    assert profiling.generation_flops(n, 2, 16, 3, 2) == 2 * n * 2 * 16 * 6


# ----------------------------------------------------------------- exports

@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["scan", "unrolled"])
def test_exports_load_in_jax(tmp_path, scan_layers):
    """The port's `params.msgpack` (in the config's layer layout) through
    JAX's `load_pretrained(target_params=...)`, and its `model.safetensors`
    through JAX's `load_torch_checkpoint`, give the JAX model's logits
    within 1e-5 of the port's; the port's readers give its weights back
    bitwise, and `params_to_jax` is the inverse of `params_from_jax`."""
    jcfg, cfg, tree = jax_setup(scan_layers=scan_layers, qkv_bias=True)
    model = port_model(cfg, tree)
    sd = model.state_dict()
    ckpt.save_pretrained(tmp_path, sd, cfg)
    ckpt.save_pretrained_torch(tmp_path, sd, cfg)
    x = ids(cfg, 1)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).long(),
                           torch.from_numpy(x).long())["logits"].numpy()
    jparams, _ = jax_ckpt.load_pretrained(tmp_path, target_params=tree)
    for params in (jparams, jax_ckpt.load_torch_checkpoint(tmp_path, jcfg)):
        want = JaxModel(jcfg).apply({"params": params}, jnp.asarray(x),
                                    jnp.asarray(x))["logits"]
        np.testing.assert_allclose(np.asarray(want), got, atol=1e-5, rtol=0)
    back, back_cfg = ckpt.load_pretrained(tmp_path)
    assert back_cfg.scan_layers == scan_layers
    for name, v in sd.items():
        assert torch.equal(back[name], v), name
        assert torch.equal(ckpt.load_torch_checkpoint(tmp_path, cfg)[name],
                           v), name
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           params_to_jax(params_from_jax(tree, cfg), cfg),
                           tree)


def test_reader_needs_no_msgpack_package(tmp_path, monkeypatch):
    """A `params.msgpack` that the JAX package writes reads back bitwise
    with the `msgpack` package made unimportable."""
    jcfg, cfg, tree = jax_setup(scan_layers=False)
    jax_ckpt.save_pretrained(tmp_path, tree, jcfg)
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError):
        import msgpack as _  # noqa: F401
    sd, _ = ckpt.load_pretrained(tmp_path)
    for name, v in params_from_jax(tree, cfg).items():
        assert torch.equal(sd[name], v), name


def test_msgpack_codec_matches_the_package():
    """Every type flax's files use, at every size boundary of the format:
    the port's bytes are the `msgpack` package's, and each reads the
    other's."""
    values = [None, True, False, 0, 127, 128, 255, 256, 65535, 65536,
              2 ** 32, 2 ** 64 - 1, -1, -32, -33, -129, -2 ** 31 - 1,
              -2 ** 63, 1.5, "", "a" * 31, "b" * 32, "c" * 300,
              "d" * 70000, b"", b"x" * 300, b"y" * 70000, [], [1] * 15,
              [1] * 16, [2] * 70000, {str(i): i for i in range(15)},
              {str(i): i for i in range(16)},
              {str(i): [i] for i in range(70000)}]
    for v in values:
        data = msgpack.packb(v, use_bin_type=True)
        assert _msgpack.pack(v) == data, str(v)[:40]
        assert _msgpack.unpack(data) == v, str(v)[:40]
    for n in (1, 2, 3, 4, 8, 16, 17, 300, 70000):
        data = msgpack.packb(msgpack.ExtType(5, b"z" * n))
        assert _msgpack.pack(_msgpack.ExtType(5, b"z" * n)) == data
        assert _msgpack.unpack(data) == _msgpack.ExtType(5, b"z" * n)
    assert _msgpack.unpack(msgpack.packb(1.25, use_single_float=True)) == 1.25


# -------------------------------------------------------------- checkpoint

def snapshot(state):
    return {k: (v.clone() if torch.is_tensor(v) else v)
            for k, v in ckpt._state_tensors(state).items()}


def train_state(cfg, accumulate=2):
    model = STMaskGIT(cfg).init_weights(torch.Generator().manual_seed(0))
    opt = TrainOptimizer(model, cfg, learning_rate=1e-2, weight_decay=0.1,
                         lr_scheduler_type="cosine", num_warmup_steps=1,
                         num_training_steps=10,
                         gradient_accumulation_steps=accumulate)
    return make_train_step(model, opt, cfg, device="cpu",
                           generator=torch.Generator().manual_seed(1))


def test_checkpointer_round_trip_and_resume(tmp_path):
    """A save mid-accumulation (one update made, one micro-batch into the
    next) restores bitwise into a fresh state: every parameter, both AdamW
    moments and their step, the running mean, the counters and the
    generator. The resumed run then equals the uninterrupted one exactly."""
    cfg = genie_tiny(**SIZE, mlp_drop=0.1)  # the generator draws masks too
    rng = np.random.default_rng(3)
    batches = [torch.from_numpy(rng.integers(0, cfg.image_vocab_size,
                                             (2, cfg.T, 4, 4)))
               for _ in range(7)]
    step = train_state(cfg)
    for b in batches[:3]:
        step(b)
    assert (step.state.optimizer.updates, step.state.optimizer.micro) == (1, 1)
    saver = ckpt.Checkpointer(tmp_path)
    saver.save(step.state, "step_x")
    saved = snapshot(step.state)
    rest = [step(b) for b in batches[3:]]  # trains on while the save writes
    saver.wait_until_finished()

    resumed = train_state(cfg)
    fresh = snapshot(resumed.state)
    saver.restore("step_x", resumed.state)
    got = snapshot(resumed.state)
    assert set(got) == set(saved) and set(got) != set(fresh)
    for k, v in saved.items():
        assert torch.equal(got[k], v), k
    assert resumed.state.step == 3
    again = [resumed(b) for b in batches[3:]]
    for a, b in zip(rest, again):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for (n, p), q in zip(step.state.model.named_parameters(),
                         resumed.state.model.parameters()):
        assert torch.equal(p, q), n
    assert ckpt.Checkpointer(tmp_path).latest_step() is None
    saver.save(resumed.state, "step_7", wait=True)
    assert saver.latest_step() == 7


# --------------------------------------------------------------------- CLI

def make_dataset(root, n=80, s=4, vocab=64):
    rng = np.random.RandomState(0)
    write_token_dataset(root, rng.randint(0, vocab, (n, s, s)).astype(
        np.uint32), vocab_size=vocab, segment_ids=np.zeros(n, np.int32))
    return root


def run_cli(argv, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "tpu1x_torch.train.train",
                           *argv, "--device", "cpu"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_train_cli_end_to_end(tmp_path):
    """As tests/test_cli.py drives the JAX trainer: three updates with eval,
    a checkpoint and a rollout, both final exports, then a resume."""
    data = make_dataset(tmp_path / "data")
    genie_tiny(num_layers=1, d_model=16, num_prompt_frames=2).save_pretrained(
        tmp_path / "config.json")
    common = ["--train_data_dir", str(data), "--val_data_dir", str(data),
              "--genie_config", str(tmp_path / "config.json"),
              "--output_dir", str(tmp_path / "out"), "--window_size", "4",
              "--stride", "1", "--per_device_train_batch_size", "2",
              "--report_to", "jsonl"]
    r = run_cli(common + [
        "--per_device_eval_batch_size", "1", "--max_train_steps", "3",
        "--eval_every_n_steps", "2", "--max_eval_steps", "1",
        "--vis_every_n_steps", "3", "--checkpointing_steps", "2",
        "--learning_rate", "1e-3"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    out = tmp_path / "out"
    for name in ("params.msgpack", "model.safetensors", "config.json"):
        assert (out / "final_checkpt_hf" / name).exists(), name
    assert (out / "step_2_hf" / "params.msgpack").exists()
    lines = [json.loads(x) for x in
             (out / "metrics.jsonl").read_text().splitlines()]
    assert any("train_loss" in x for x in lines)
    assert any("eval_loss" in x for x in lines)
    video = np.fromfile(out / "vis_step_3" / "video.bin", dtype=np.uint32)
    assert video.size == 4 * (4 + 2) * 16 and video.max() < 64

    r2 = run_cli(common + ["--max_train_steps", "4",
                           "--eval_every_n_steps", "100",
                           "--checkpointing_steps", "100",
                           "--resume_from_checkpoint", str(out / "step_2")],
                 tmp_path)
    assert r2.returncode == 0, r2.stderr[-3000:]
    assert "resumed from step_2" in r2.stdout


def test_loop_matches_the_jax_trainer(tmp_path, monkeypatch):
    """Both trainers warm-start from one checkpoint that the JAX package
    writes, on the same data (each its own `ShardedBatchLoader`, one seed,
    one global batch),
    the port's corruption draws replaced by the JAX trainer's
    (`fold_in(state.rng, step)`): the logged train loss and gradient norm
    at updates 1 and 10, and every final weight, within 2e-4 (as
    test_torch_train.py's 50-step trajectory)."""
    from tpu1x.train import train as jax_train
    from tpu1x_torch.train import step as step_mod
    from tpu1x_torch.train import train as port_train

    data = make_dataset(tmp_path / "data", n=120)
    jcfg, cfg, tree = jax_setup()
    jax_ckpt.save_pretrained(tmp_path / "warm", tree, jcfg)
    seed = 5
    state_rng = jax.random.split(jax.random.PRNGKey(seed))[1]
    calls = []

    def jax_draws(shape, config, generator, device):
        calls.append(len(calls))
        return jax_noise(jax.random.fold_in(state_rng, calls[-1]), shape,
                         config)
    monkeypatch.setattr(step_mod, "draw_noise", jax_draws)

    def argv(out, per_device):
        return ["--train_data_dir", str(data), "--val_data_dir", str(data),
                "--genie_config", str(tmp_path / "warm" / "config.json"),
                "--warmstart_path", str(tmp_path / "warm"),
                "--output_dir", str(out), "--window_size", "4", "--stride",
                "1", "--per_device_train_batch_size", str(per_device),
                "--max_train_steps", "10", "--eval_every_n_steps", "100",
                "--vis_every_n_steps", "100", "--checkpointing_steps", "100",
                "--learning_rate", "3e-3", "--weight_decay", "0.05",
                "--max_grad_norm", "0.5", "--seed", str(seed)]
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    try:
        # one global batch of 8: JAX's 8 virtual CPU devices take one
        # example each, the port's one process all 8
        jax_train.main(argv(tmp_path / "jax", 1))
        port_train.main(argv(tmp_path / "port", 8) + ["--device", "cpu"])
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
    assert len(calls) == 10

    def logged(out):
        return [x for x in (json.loads(line) for line in
                            (out / "metrics.jsonl").read_text().splitlines())
                if "train_loss" in x]
    want, got = logged(tmp_path / "jax"), logged(tmp_path / "port")
    assert [x["step"] for x in got] == [x["step"] for x in want] == [1, 10]
    for a, b in zip(got, want):
        for key in ("train_loss", "train_acc", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], atol=2e-4, rtol=0)
    w_jax, _ = ckpt.load_pretrained(tmp_path / "jax" / "final_checkpt_hf")
    w_port, _ = ckpt.load_pretrained(tmp_path / "port" / "final_checkpt_hf")
    assert set(w_jax) == set(w_port)
    for name in w_jax:
        np.testing.assert_allclose(w_port[name].numpy(), w_jax[name].numpy(),
                                   atol=2e-4, rtol=0, err_msg=name)


# ------------------------------------------------------------------- remat

def grads_and_saved_bytes(cfg, dropout_seed=None):
    """One forward and backward of a seeded tiny model and batch; returns
    (loss, every parameter's gradient, the bytes saved for the backward)."""
    model = STMaskGIT(cfg).init_weights(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.image_vocab_size, (2, cfg.T, 4, 4),
                           generator=g)
    batch = maskgit_corrupt(tokens, draw_noise(tokens.shape, cfg, g, "cpu"),
                            cfg)
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t
    gen = torch.Generator().manual_seed(5)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = model.train()(batch["input_ids"], batch["labels"],
                            generator=gen)
    out["loss"].backward()
    return (out["loss"].detach(),
            {n: p.grad for n, p in model.named_parameters()}, saved[0])


POLICIES = ("none", "attn_outs", "dots", "dots_no_batch")


@pytest.mark.parametrize("kw", [dict(), dict(qk_norm=True),
                                dict(attn_drop=0.1, mlp_drop=0.1)],
                         ids=["pre_ln", "qk_norm", "dropout"])
def test_remat_gradients_and_saved_bytes(kw):
    """Every policy: the loss and every gradient equal remat off within
    1e-6 of the gradient's largest value (dots: the products' backward is
    written out, so sums run in another order; else bitwise), dropout masks
    included. Saved for the backward: on the qk_norm path none < attn_outs
    < off; on the fused pre-LN path attn_outs saves what remat off saves
    (the train blocks keep only their inputs) and none less."""
    off_loss, off, off_bytes = grads_and_saved_bytes(
        genie_tiny(**SIZE, remat=False, **kw))
    saved = {}
    for policy in POLICIES:
        loss, got, saved[policy] = grads_and_saved_bytes(
            genie_tiny(**SIZE, remat=True, remat_policy=policy, **kw))
        assert torch.equal(loss, off_loss), policy
        for name, g in got.items():
            scale = float(off[name].abs().max())
            assert float((g - off[name]).abs().max()) <= 1e-6 * scale, \
                (policy, name)
    if kw == dict(qk_norm=True):
        assert saved["none"] < saved["attn_outs"] < off_bytes
    if not kw:
        assert saved["attn_outs"] == off_bytes > saved["none"]


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        STMaskGIT(genie_tiny(**SIZE, remat_policy="everything"))


# ----------------------------------------------------------------- dropout

def test_dropout_is_identity_in_eval_mode():
    """attn_drop = mlp_drop = 0.1 in eval mode: the JAX model's
    (deterministic) forward; logits atol 2e-4, rtol 2e-3 (as
    test_torch_train.py)."""
    for kw in (dict(), dict(qk_norm=True)):
        jcfg, cfg, tree = jax_setup(attn_drop=0.1, mlp_drop=0.1, **kw)
        x = ids(cfg, 2)
        want = JaxModel(jcfg).apply({"params": jax.tree_util.tree_map(
            jnp.asarray, tree)}, jnp.asarray(x), jnp.asarray(x))["logits"]
        with torch.no_grad():
            got = port_model(cfg, tree).eval()(torch.from_numpy(x).long(),
                                               torch.from_numpy(x).long())
        np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want),
                                   atol=2e-4, rtol=2e-3)


def jax_block_with_masks(p, x, masks, cfg, qk_norm):
    """The JAX package's STBlock in training (tpu1x/models/st_transformer.py,
    tpu1x/ops/attention.py) written out in jnp, flax's dropout taking the
    given keep masks: dropout on each attention's output before its proj,
    after fc1's GELU and after fc2."""
    H, C = cfg.num_heads, cfg.d_model
    scale = (C // H) ** -0.5
    masks = iter(masks)

    def drop(v, rate):
        return jnp.where(next(masks), v / (1 - rate), 0.0) if rate else v

    def ln(v, q):
        mu = v.mean(-1, keepdims=True)
        var = (v * v).mean(-1, keepdims=True) - mu * mu
        return (v - mu) / jnp.sqrt(var + 1e-5) * q["scale"] + q["bias"]

    def attention(q, v, causal):
        qkv = v @ q["qkv"]["kernel"]
        qkv = qkv.reshape(v.shape[:-1] + (3, H, C // H))
        qq, kk, vv = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
        if qk_norm:
            qq, kk = ln(qq, q["norm"]), ln(kk, q["norm"])
        out = jax_mha(qq, kk, vv, scale=scale, causal=causal)
        out = drop(out, cfg.attn_drop).reshape(v.shape)
        return out @ q["proj"]["kernel"] + q["proj"]["bias"]

    h = x if qk_norm else ln(x, p["norm1"])
    x = x + attention(p["spatial_attn"], h, False)
    xt = jnp.swapaxes(x, 1, 2)
    x = jnp.swapaxes(xt + attention(p["temporal_attn"], xt, True), 1, 2)
    h = x if qk_norm else ln(x, p["norm2"])
    m = p["mlp"]
    h = jax.nn.gelu(h @ m["fc1"]["kernel"] + m["fc1"]["bias"],
                    approximate=False)
    h = drop(h, cfg.mlp_drop) @ m["fc2"]["kernel"] + m["fc2"]["bias"]
    return x + drop(h, cfg.mlp_drop)


@pytest.mark.parametrize("qk_norm", [False, True], ids=["pre_ln", "qk_norm"])
def test_dropout_in_training_is_the_jax_formula(qk_norm, monkeypatch):
    """One STBlock in training with attn_drop 0.2 and mlp_drop 0.1: the
    port's output equals the JAX formula given the masks the port drew
    (atol 1e-5, fp32), and every mask keeps at its rate."""
    jcfg, cfg, tree = jax_setup(attn_drop=0.2, mlp_drop=0.1, qk_norm=qk_norm,
                                scan_layers=False)
    model = port_model(cfg, tree)
    block = model.decoder.layers[0].train()
    masks = []
    real = st_transformer.dropout

    def recorded(x, p, generator=None):
        out = real(x, p, generator)
        masks.append((out != 0).numpy())
        return out
    monkeypatch.setattr(st_transformer, "dropout", recorded)
    x = np.random.default_rng(4).standard_normal(
        (2, cfg.T, cfg.S, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        got = block(torch.from_numpy(x),
                    generator=torch.Generator().manual_seed(0))
    assert len(masks) == 4  # two attentions, after fc1, after fc2
    want = jax_block_with_masks(
        jax.tree_util.tree_map(jnp.asarray, tree["decoder"]["layers_0"]),
        jnp.asarray(x), [jnp.asarray(m) for m in masks], cfg, qk_norm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_dropout_rate_and_scale():
    """Keep rate 1 - p within five standard deviations over a million
    values; every kept value scaled by exactly 1 / (1 - p) (a power of two
    here); the same generator seed, the same mask."""
    x = torch.ones(1_000_000)
    for p in (0.1, 0.5, 0.75):
        y = st_transformer.dropout(x, p, torch.Generator().manual_seed(0))
        kept = y != 0
        n = x.numel()
        assert abs(float(kept.float().mean()) - (1 - p)) <= \
            5 * (p * (1 - p) / n) ** 0.5
        assert torch.all(y[kept] == torch.tensor(1 / (1 - p)))
        assert torch.equal(y, st_transformer.dropout(
            x, p, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="generator"):
        st_transformer.dropout(x, 0.1, None)


def test_dropout_takes_the_op_by_op_route(monkeypatch):
    """With both rates above 0 no fused train block runs in training (as
    JAX routes away from its Pallas sub-layers); in eval mode they do."""
    cfg = genie_tiny(**SIZE, attn_drop=0.1, mlp_drop=0.1)
    model = STMaskGIT(cfg).init_weights(torch.Generator().manual_seed(0))
    calls = []
    ops = st_transformer.STBlock.ops
    monkeypatch.setattr(st_transformer.STBlock, "ops", type(ops)(**{
        k: (lambda f, k=k: lambda *a, **kw: calls.append(k) or f(*a, **kw))(
            v) for k, v in vars(ops).items()}))
    x = torch.from_numpy(ids(cfg, 0)).long()
    model.train()(x, x, generator=torch.Generator().manual_seed(0))
    assert set(calls) == {"mha"}
    calls.clear()
    with torch.no_grad():
        model.eval()(x, x)
    assert set(calls) == {"spatial", "temporal", "mlp"}


# ---------------------------------------------------- prefetch, profiling

def test_prefetcher_order_errors_and_close():
    """The batches in order as int64 tensors; a loader error raised at its
    batch on the consumer side; a closed prefetcher's thread ends."""
    batches = [{"tokens": np.full((2, 3), i, np.int32),
                "actions": np.full((2, 4), -i, np.int32)} for i in range(5)]
    got = list(DevicePrefetcher(iter(batches), "cpu", depth=2))
    assert [int(t[0, 0]) for t, _ in got] == list(range(5))
    assert all(t.dtype == torch.int64 and a.dtype == torch.int64
               for t, a in got)

    def failing():
        yield {"tokens": np.zeros((1, 1))}
        raise OSError("disk")
    it = iter(DevicePrefetcher(failing(), "cpu"))
    next(it)
    with pytest.raises(OSError, match="disk"):
        next(it)

    endless = ({"tokens": np.zeros((1, 1))} for _ in iter(int, 1))
    with DevicePrefetcher(endless, "cpu", depth=1) as pf:
        next(iter(pf))
    assert not pf._thread.is_alive()


def test_profiling_helpers(tmp_path):
    """No card here: no peak; the stopwatch times host work; the trace is
    written."""
    assert profiling.device_peak_flops() is None
    assert profiling.Stopwatch(lambda: sum(range(1000)))(iters=3) > 0
    with profiling.profile_trace(tmp_path):
        torch.ones(4).sum()
    assert (tmp_path / "trace.json").exists()
