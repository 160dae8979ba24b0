"""Tensor parallelism of the port on the CPU (`tpu1x_torch/parallel/`).

- `shard_state_dict` and `gather_state_dict` are inverse, and a rank's qkv
  shard is its heads of q, of k and of v.
- Each TP sub-layer (spatial, temporal, MLP with and without LN) at tp = 2
  and 4 in one process: the ranks' launch sequences run side by side, their
  fp32 partials summed here, and the values and every gradient held to the
  whole layer's plain version (ordinary autograd) and to the JAX package's
  `*_train_block_reference` under `jax.vjp`, in fp32, within 1e-5 of each
  element plus 1e-5 of the tensor's largest (the same products, summed in
  another order).
- gloo process groups, each process its own interpreter with a timeout, all
  started at once by one module fixture: tp = 2 on two processes, dp = 2 x
  tp = 2 on four, dp = 2 x tp = 2 with FSDP2 on four, and tp = 4 on four
  at d_model 64 with 8 heads (2 heads a rank, as GENIE_35M's 8 heads at
  tp = 4). Each trains a
  pre-LN and a qk_norm tiny fp32 model for three updates of two
  micro-batches; every micro-batch's loss, accuracy and gradient norm and
  the gathered parameters after each update are held to one process here
  within rtol 1e-5 (atol 1e-8), as tests/test_torch_parallel.py holds DDP
  (AdamW's eps 1e-3 keeps the update linear in the gradient, see there).
  The first update, whose corruption takes the JAX trainer's draws, is also
  held to the JAX package's step on a `make_mesh(dp, tp)` of its virtual
  CPU devices: loss and gradient norm rtol 1e-5, parameters atol 5e-6 at a
  learning rate of 1e-3 (tests/test_torch_train.py's one-step gates).
- On the tp = 2 group: one step with dropout, after which the replicated
  parameters and a training forward's logits agree bit for bit between the
  ranks of the model group; `RolloutEngine(mesh=)` over both ranks, token
  for token the one-process rollout at temperature 0 and 1 with two futures
  a prompt, and `score_policies` within 1e-6 of one process and rtol 1e-4
  (tests/test_torch_eval.py's parity gate) of the JAX engine on a dp 4 x
  tp 2 mesh.
- On the FSDP2 group: the whole-weight exports (both layouts) made right
  after the split equal the one-process exports of the same weights byte
  for byte; a `Checkpointer` save after update 2 restores into a fresh TP +
  FSDP2 state bit for bit; a restore at tp = 1 raises, naming both layouts.
- The train CLI with `--tp 2` on two processes: two updates, then a resume
  from update 1 to the same final weights; `--tp 3` raises.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpu1x_torch.parallel import tensor as tp_lib

ROOT = Path(__file__).resolve().parent.parent
SIZE = dict(T=4, num_prompt_frames=2, num_heads=4, d_model=32)
ARCHS = ("pre_ln", "qk_norm")
LAYOUTS = {"tp2": (1, 2, False), "dp2tp2": (2, 2, False),
           "dp2tp2_fsdp": (2, 2, True), "tp4": (1, 4, False)}
# a layout's widths where not SIZE's: 2 heads a rank at tp = 4
WIDER = {"tp4": dict(num_heads=8, d_model=64)}
GLOBAL_B, ACCUMULATE, UPDATES = 4, 2, 3
OPT = dict(learning_rate=1e-3, weight_decay=0.1, eps=1e-3, max_grad_norm=0.5,
           lr_scheduler_type="cosine", num_warmup_steps=1,
           num_training_steps=UPDATES, gradient_accumulation_steps=ACCUMULATE)
TIMEOUT = 300
TOL = dict(atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ state dicts

def test_shard_then_gather_is_the_identity():
    from tpu1x_torch.model_zoo import genie_tiny
    from tpu1x_torch.models.st_maskgit import STMaskGIT
    cfg = genie_tiny(**SIZE)
    sd = STMaskGIT(cfg).init_weights(torch.Generator().manual_seed(0)) \
        .state_dict()
    for tp in (2, 4):
        shards = [tp_lib.shard_state_dict(sd, r, tp, cfg.num_heads)
                  for r in range(tp)]
        assert set(shards[0]) == set(sd)
        whole = tp_lib.gather_state_dict(shards, cfg.num_heads)
        assert all(torch.equal(whole[k], v) for k, v in sd.items())
        name = "decoder.layers.0.spatial_attn.qkv.weight"
        C, H = cfg.d_model, cfg.num_heads
        D, h = C // H, H // tp
        for r in range(tp):
            # rows (3, H, D): rank r's heads of q, of k and of v
            want = sd[name].view(3, H, D, C)[:, r * h:(r + 1) * h]
            assert torch.equal(shards[r][name], want.reshape(-1, C))
            assert shards[r]["decoder.layers.0.mlp.fc2.weight"].shape == \
                (C, 4 * C // tp)
            assert torch.equal(shards[r]["decoder.layers.0.norm1.weight"],
                               sd["decoder.layers.0.norm1.weight"])


# ------------------------------------------------ sub-layers, one process

def over_ranks(steps):
    """Run the ranks' launch sequences side by side: their partials summed
    here and sent back to each. Returns each rank's result."""
    parts = [next(s) for s in steps]
    total = torch.stack(parts).sum(0)
    out = []
    for s in steps:
        with pytest.raises(StopIteration) as done:
            s.send(total.clone())
        out.append(done.value.value)
    return out


def rand(rng, *shape, scale=1.0, mean=0.0):
    return (mean + scale * rng.standard_normal(shape)).astype(np.float32)


def whole_grads(torch_fn, jax_fn, args, cot):
    """The whole layer's output and gradients (of sum(out * cot)) by
    autograd of the port's plain version, and the JAX reference's by
    jax.vjp; every array argument differentiated."""
    import jax
    import jax.numpy as jnp
    names = [k for k, v in args.items() if v is not None]
    leaves = {k: torch.from_numpy(args[k]).requires_grad_(True)
              for k in names}
    out = torch_fn(**dict(args, **leaves))
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                [leaves[k] for k in names])
    jout, vjp = jax.vjp(lambda *v: jax_fn(**dict(args, **dict(zip(names, v)))),
                        *(jnp.asarray(args[k]) for k in names))
    jgrads = vjp(jnp.asarray(cot))
    return ((out.detach(), dict(zip(names, grads))),
            (np.asarray(jout), dict(zip(names, map(np.asarray, jgrads)))))


def held(name, got, want_torch, want_jax):
    """Within 1e-5 of each, relative to the element and to the tensor's
    largest element (a weight gradient sums the 512 rows of (2, 4, 64))."""
    for want in (want_torch.numpy(), np.asarray(want_jax)):
        np.testing.assert_allclose(
            got.numpy(), want, err_msg=name, rtol=TOL["rtol"],
            atol=TOL["atol"] * max(1.0, float(np.abs(want).max())))


C, H, S, N, TT = 128, 4, 64, 2, 4


# the sub-layers' (tp, C, heads) beyond C and H: 2 heads of 64 and 2 of
# 128 a rank at tp = 2, the head widths of GENIE_138M-h64's and -h128's
# ranks (ids as before those existed)
SUB_LAYER_CASES = [pytest.param(2, C, H, id="2"),
                   pytest.param(4, C, H, id="4"),
                   pytest.param(2, 256, 4, id="2-h64"),
                   pytest.param(2, 512, 4, id="2-h128")]


def shard(name, a, r, tp, heads=H):
    """Rank r's share of the (in, out) numpy weight or bias `a` named by
    its torch parameter `name`, in the torch layout as a tensor."""
    t = torch.from_numpy(a)
    t = t.t() if t.dim() == 2 else t
    return tp_lib.shard_tensor(name, t, r, tp, heads).contiguous()


def whole(name, parts, heads=H):
    """The whole (in, out) gradient from its ranks' (in, out) shares."""
    t = tp_lib.unshard_tensor(name, [p.t() if p.dim() == 2 else p
                                     for p in parts], heads)
    return t.t() if t.dim() == 2 else t


@pytest.mark.parametrize("tp,C_,H_", SUB_LAYER_CASES)
def test_tp_spatial_sub_layer(tp, C_, H_):
    from tpu1x.ops.spatial_train_block import spatial_train_block_reference
    from tpu1x_torch.ops.spatial_train_block import (
        spatial_train_block_plain, spatial_train_block_steps)
    rng = np.random.default_rng(tp)
    args = dict(x=rand(rng, N, S, C_),
                wqkv=rand(rng, C_, 3 * C_, scale=0.05),
                wproj=rand(rng, C_, C_, scale=0.05),
                bqkv=rand(rng, 3 * C_, scale=0.02),
                bproj=rand(rng, C_, scale=0.02),
                ln_scale=rand(rng, C_, scale=0.1, mean=1.0),
                ln_bias=rand(rng, C_, scale=0.1))
    kw = dict(num_heads=H_, scale=(C_ // H_) ** -0.5)
    cot = rand(rng, N, S, C_)
    (want, grads), (jwant, jgrads) = whole_grads(
        lambda **a: spatial_train_block_plain(**a, **kw),
        lambda **a: spatial_train_block_reference(**a, **kw), args, cot)
    t = {k: torch.from_numpy(v) for k, v in args.items()}
    ranks = [dict(wqkv_t=shard("spatial_attn.qkv.weight", args["wqkv"], r,
                               tp, H_).t().contiguous(),
                  wproj=shard("spatial_attn.proj.weight", args["wproj"], r,
                              tp, H_),
                  bqkv=shard("spatial_attn.qkv.bias", args["bqkv"], r, tp,
                             H_))
             for r in range(tp)]
    local = dict(num_heads=H_ // tp, scale=kw["scale"])
    outs = over_ranks([tp_lib.spatial_fwd(
        t["x"], w["wqkv_t"], w["wproj"], w["bqkv"], t["bproj"],
        t["ln_scale"], t["ln_bias"], **local) for w in ranks])
    got = over_ranks([spatial_train_block_steps(
        t["x"], torch.from_numpy(cot), w["wqkv_t"], w["wproj"].t(),
        w["bqkv"], t["ln_scale"], t["ln_bias"], proj_bias=True, **local)
        for w in ranks])
    for r in range(tp):
        held("out", outs[r], want, jwant)
        held("x", got[r][0], grads["x"], jgrads["x"])
        for i, k in ((4, "bproj"), (5, "ln_scale"), (6, "ln_bias")):
            held(k, got[r][i], grads[k], jgrads[k])
    for i, k, name in ((1, "wqkv", "spatial_attn.qkv.weight"),
                       (2, "wproj", "spatial_attn.proj.weight"),
                       (3, "bqkv", "spatial_attn.qkv.bias")):
        held(k, whole(name, [g[i] for g in got], H_), grads[k], jgrads[k])


@pytest.mark.parametrize("tp,C_,H_", SUB_LAYER_CASES)
def test_tp_temporal_sub_layer(tp, C_, H_):
    from tpu1x.ops.temporal_train_block import temporal_train_block_reference
    from tpu1x_torch.ops.temporal_train_block import (
        temporal_train_block_plain, temporal_train_block_steps)
    rng = np.random.default_rng(10 + tp)
    args = dict(x=rand(rng, N, TT, S, C_),
                wqkv=rand(rng, C_, 3 * C_, scale=0.05),
                wproj=rand(rng, C_, C_, scale=0.05),
                bqkv=rand(rng, 3 * C_, scale=0.02),
                bproj=rand(rng, C_, scale=0.02))
    kw = dict(num_heads=H_, scale=(C_ // H_) ** -0.5)
    cot = rand(rng, N, TT, S, C_)
    (want, grads), (jwant, jgrads) = whole_grads(
        lambda **a: temporal_train_block_plain(**a, **kw),
        lambda **a: temporal_train_block_reference(**a, **kw), args, cot)
    t = {k: torch.from_numpy(v) for k, v in args.items()}
    ranks = [dict(wqkv_t=shard("temporal_attn.qkv.weight", args["wqkv"], r,
                               tp, H_).t().contiguous(),
                  wproj=shard("temporal_attn.proj.weight", args["wproj"], r,
                              tp, H_),
                  bqkv=shard("temporal_attn.qkv.bias", args["bqkv"], r, tp,
                             H_))
             for r in range(tp)]
    local = dict(num_heads=H_ // tp, scale=kw["scale"])
    outs = over_ranks([tp_lib.temporal_fwd(
        t["x"], w["wqkv_t"], w["wproj"], w["bqkv"], t["bproj"], **local)
        for w in ranks])
    got = over_ranks([temporal_train_block_steps(
        t["x"], torch.from_numpy(cot), w["wqkv_t"],
        w["wproj"].t().contiguous(), w["bqkv"], proj_bias=True, split=True,
        **local) for w in ranks])
    for r in range(tp):
        held("out", outs[r], want, jwant)
        held("x", got[r][0], grads["x"], jgrads["x"])
        held("bproj", got[r][4], grads["bproj"], jgrads["bproj"])
    for i, k, name in ((1, "wqkv", "temporal_attn.qkv.weight"),
                       (2, "wproj", "temporal_attn.proj.weight"),
                       (3, "bqkv", "temporal_attn.qkv.bias")):
        held(k, whole(name, [g[i] for g in got], H_), grads[k], jgrads[k])


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("pre_ln", [True, False])
def test_tp_mlp_sub_layer(tp, pre_ln):
    from tpu1x.ops.mlp_train_block import mlp_train_block_reference
    from tpu1x_torch.ops.mlp_train_block import (mlp_train_block_plain,
                                                 mlp_train_block_steps)
    rng = np.random.default_rng(20 + tp + pre_ln)
    F4 = 4 * C
    args = dict(x=rand(rng, N, S, C), wfc1=rand(rng, C, F4, scale=0.05),
                wfc2=rand(rng, F4, C, scale=0.05),
                bfc1=rand(rng, F4, scale=0.02), bfc2=rand(rng, C, scale=0.02),
                ln_scale=rand(rng, C, scale=0.1, mean=1.0) if pre_ln
                else None,
                ln_bias=rand(rng, C, scale=0.1) if pre_ln else None)
    cot = rand(rng, N, S, C)
    (want, grads), (jwant, jgrads) = whole_grads(
        mlp_train_block_plain, mlp_train_block_reference, args, cot)
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in args.items()}
    ranks = [dict(wfc1_t=shard("mlp.fc1.weight", args["wfc1"], r,
                               tp).t().contiguous(),
                  wfc2=shard("mlp.fc2.weight", args["wfc2"], r, tp),
                  bfc1=shard("mlp.fc1.bias", args["bfc1"], r, tp))
             for r in range(tp)]
    outs = over_ranks([tp_lib.mlp_fwd(
        t["x"], w["wfc1_t"], w["wfc2"], w["bfc1"], t["bfc2"], t["ln_scale"],
        t["ln_bias"], gelu_approx=False) for w in ranks])
    got = over_ranks([mlp_train_block_steps(
        t["x"], torch.from_numpy(cot), w["wfc1_t"],
        w["wfc2"].t().contiguous(), w["bfc1"], t["ln_scale"], t["ln_bias"],
        gelu_approx=False, bias=True, split=True) for w in ranks])
    replicated = [(4, "bfc2")] + ([(5, "ln_scale"), (6, "ln_bias")]
                                  if pre_ln else [])
    for r in range(tp):
        held("out", outs[r], want, jwant)
        held("x", got[r][0], grads["x"], jgrads["x"])
        for i, k in replicated:
            held(k, got[r][i], grads[k], jgrads[k])
    for i, k, name in ((1, "wfc1", "mlp.fc1.weight"),
                       (2, "wfc2", "mlp.fc2.weight"),
                       (3, "bfc1", "mlp.fc1.bias")):
        held(k, whole(name, [g[i] for g in got]), grads[k], jgrads[k])


# ------------------------------------------------------------ gloo groups

def config(arch, layout=None, **kw):
    """The tiny config of `arch` at `layout`'s widths."""
    from tpu1x_torch.model_zoo import genie_tiny
    return genie_tiny(**{**SIZE, **WIDER.get(layout, {})},
                      qk_norm=arch == "qk_norm", **kw)


def key(arch, layout=None):
    """The inputs' entry of `arch` at `layout`'s widths."""
    return arch if layout not in WIDER else f"{arch}/{layout}"


def train(state, cfg, batches, rows, noise, on_update=None):
    """Every micro-batch's metrics and the whole parameters after each
    update; micro-batch i takes noise[i] where given (the JAX trainer's
    draws), else the generator's."""
    from tpu1x_torch.parallel.sharding import full_state_dict
    from tpu1x_torch.train.step import make_train_step
    step = make_train_step(state.model, state.optimizer, cfg, device="cpu",
                           generator=state.generator)
    metrics, params = [], {}
    for i, batch in enumerate(batches):
        m = step(batch[rows], noise=noise[i] if i < len(noise) else None)
        metrics.append({k: float(v) for k, v in m.items()})
        if step.state.optimizer.micro == 0:
            updates = step.state.optimizer.updates
            params[updates] = {k: v.clone() for k, v in
                               full_state_dict(step.state.model).items()}
            if on_update is not None:
                on_update(step.state, updates)
    return metrics, params, step.state


def fresh_state(cfg, init):
    from tpu1x_torch.models.st_maskgit import STMaskGIT
    from tpu1x_torch.train.optim import TrainOptimizer
    from tpu1x_torch.train.step import TrainState
    model = STMaskGIT(cfg)
    model.load_state_dict(init)
    return TrainState(0, model, TrainOptimizer(model, cfg, **OPT),
                      torch.Generator().manual_seed(1))


def local_tensors(state):
    from tpu1x_torch.train.checkpoint import _state_tensors
    return {k: (v.to_local() if hasattr(v, "to_local") else v).clone()
            for k, v in _state_tensors(state).items()}


def exports(sd, cfg, out):
    from tpu1x_torch.train.checkpoint import (save_pretrained,
                                              save_pretrained_torch)
    save_pretrained(out, sd, cfg)
    save_pretrained_torch(out, sd, cfg)


def groups_agree(t, m):
    """Whether `t` is the same, bit for bit, on every rank of the model
    group (every rank calls)."""
    from tpu1x_torch.parallel.mesh import gather_rows
    parts = gather_rows(t.detach()[None], slice(m.model_index,
                                                m.model_index + 1), m.tp,
                        m.model_group)
    return all(torch.equal(p, parts[0]) for p in parts)


def worker(layout: str, tmp: str):
    """One rank of `layout`; rank 0 writes the results."""
    import torch.distributed as dist

    from tpu1x_torch.parallel import mesh
    from tpu1x_torch.parallel.sharding import full_state_dict, mesh_of
    from tpu1x_torch.train.checkpoint import Checkpointer
    from tpu1x_torch.train.step import make_train_step, shard_train_state
    torch.set_num_threads(1)
    tmp = Path(tmp)
    dp, tp, fsdp = LAYOUTS[layout]
    assert mesh.init_distributed("cpu")
    assert mesh.process_count() == dp * tp
    inputs = torch.load(tmp / "inputs.pt", weights_only=False)
    rank0 = mesh.process_index() == 0
    result = {}
    for arch in ARCHS:
        cfg = config(arch, layout)
        state = shard_train_state(
            fresh_state(cfg, inputs[key(arch, layout)]["init"]), "cpu",
            fsdp=fsdp, tp=tp)
        m = mesh_of(state.model)
        assert (m.dp, m.tp) == (dp, tp)
        if fsdp and arch == "pre_ln":
            sd = full_state_dict(state.model)
            if rank0:
                exports(sd, cfg, tmp / f"export_{layout}")
        saved, ckpt = {}, Checkpointer(tmp / f"ckpt_{layout}")

        def on_update(s, updates):
            if fsdp and arch == "pre_ln" and updates == 2:
                ckpt.save(s, "step_2", wait=True)
                saved.update(local_tensors(s))
        metrics, params, state = train(
            state, cfg, inputs["batches"], mesh.data_rows(GLOBAL_B, m),
            inputs[key(arch, layout)]["noise"], on_update)
        result[arch] = {"metrics": metrics, "params": params}
        if fsdp and arch == "pre_ln":
            again = shard_train_state(fresh_state(cfg, inputs[arch]["init"]),
                                      "cpu", fsdp=True, tp=tp)
            again = make_train_step(again.model, again.optimizer, cfg,
                                    device="cpu",
                                    generator=again.generator).state
            ckpt.restore("step_2", again)
            got = local_tensors(again)
            same = torch.tensor(int(set(got) == set(saved) and all(
                torch.equal(got[k], v) for k, v in saved.items())))
            dist.all_reduce(same, op=dist.ReduceOp.MIN)
            other = shard_train_state(fresh_state(cfg, inputs[arch]["init"]),
                                      "cpu", fsdp=True, tp=1)
            other = make_train_step(other.model, other.optimizer, cfg,
                                    device="cpu",
                                    generator=other.generator).state
            try:
                ckpt.restore("step_2", other)
                refused = ""
            except ValueError as e:
                refused = str(e)
            result["checkpoint"] = dict(
                bitwise=bool(same), keys=len(got), step=again.step,
                split_keys=sum("/tp" in k for k in got), refused=refused)
    if layout == "tp2":
        result.update(dropout_and_rollout(inputs))
    if rank0:
        torch.save(result, tmp / f"result_{layout}.pt")
    dist.destroy_process_group()


def dropout_and_rollout(inputs):
    """The tp = 2 group's other checks (every rank calls)."""
    from tpu1x_torch.parallel.sharding import mesh_of
    from tpu1x_torch.rollout.engine import RolloutEngine
    from tpu1x_torch.train.step import make_train_step, shard_train_state
    out = {}
    cfg = config("pre_ln", attn_drop=0.1, mlp_drop=0.1)
    state = shard_train_state(fresh_state(cfg, inputs["pre_ln"]["init"]),
                              "cpu", tp=2)
    step = make_train_step(state.model, state.optimizer, cfg, device="cpu",
                           generator=state.generator)
    step(inputs["batches"][0])
    model = step.state.model.module
    m = mesh_of(model)
    replicated = [p for n, p in model.named_parameters()
                  if not tp_lib.is_split(n)]
    g = torch.Generator().manual_seed(3)
    ids = inputs["batches"][1].reshape(GLOBAL_B, -1)
    with torch.no_grad():
        logits = model.train()(ids, ids, generator=g)["logits"]
        plain = model.eval()(ids, ids)["logits"]
    out["dropout"] = dict(
        params_agree=all(groups_agree(p, m) for p in replicated),
        logits_agree=groups_agree(logits, m),
        differs_from_eval=not torch.equal(logits, plain))
    # gradients of the replicated parameters that part between the ranks
    # (as the card's fp32 atomics leave them): the optimizer makes them
    # alike, so the parameters stay equal bit for bit
    opt = step.state.optimizer
    inner = opt.step

    def parted():
        for p in replicated:
            if p.grad is not None:
                p.grad.add_(1e-3 * (1 + m.model_index))
        return inner()
    opt.step = parted
    for batch in inputs["batches"][1:1 + opt.accumulate]:
        step(batch)
    opt.step = inner
    out["grads_part"] = all(groups_agree(p, m) for p in replicated)
    cfg = config("pre_ln")
    rollouts = {}
    for temperature in (0.0, 1.0):
        engine = RolloutEngine(inputs["pre_ln"]["init"], cfg, device="cpu",
                               temperature=temperature, mesh=m)
        rollouts[temperature] = engine.rollout(
            inputs["prompt"], cfg.T - 2, torch.Generator().manual_seed(5),
            num_futures=2)
    out["rollouts"] = rollouts
    out["scores"] = engine.score_policies(inputs["context"],
                                          inputs["continuations"])
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(argv, world, cwd, extra_env=None):
    """`world` processes of `argv`, joined through torchrun's variables."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS="1", RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   **(extra_env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, *argv], cwd=cwd, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def finish(procs):
    outputs = []
    for p in procs:
        try:
            outputs.append(p.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, o in zip(procs, outputs):
        assert p.returncode == 0, o[-4000:]
    return outputs


def make_inputs(tmp):
    """The weights (a JAX tree made with numpy, as tests/test_torch_train.py
    makes it), the global batches, the JAX trainer's corruption draws of
    the first update, the rollout prompts and the scored policies. What the
    processes read is saved to `tmp` (no object of the JAX package)."""
    import jax
    import jax.numpy as jnp
    from tpu1x.model_zoo import genie_tiny as jax_tiny
    from tpu1x.models.st_maskgit import STMaskGIT as JaxModel
    from tpu1x_torch.weights import params_from_jax
    inputs = {}
    rng = np.random.default_rng(1)
    inputs["batches"] = [torch.from_numpy(rng.integers(
        0, 64, (GLOBAL_B, SIZE["T"], 4, 4))) for _ in range(
            UPDATES * ACCUMULATE)]
    for layout in (None, *WIDER):
        for i, arch in enumerate(ARCHS):
            jcfg = jax_tiny(**{**SIZE, **WIDER.get(layout, {})},
                            qk_norm=arch == "qk_norm", remat=False,
                            attn_impl="xla")
            dummy = jnp.zeros((1, jcfg.T * jcfg.S), jnp.int32)
            tree = jax.device_get(JaxModel(jcfg).init(
                jax.random.PRNGKey(0), dummy, dummy)["params"])
            tree = random_tree(tree, i)
            rngs = [jax.random.fold_in(jax.random.PRNGKey(7), k)
                    for k in range(ACCUMULATE)]
            cfg = config(arch, layout)
            inputs[key(arch, layout)] = dict(
                jcfg=jcfg, tree=tree, init=params_from_jax(tree, cfg),
                noise=[jax_noise(r, inputs["batches"][0].shape, cfg)
                       for r in rngs])
    inputs["prompt"] = torch.from_numpy(rng.integers(0, 64, (2, 2, 4, 4)))
    inputs["context"] = torch.from_numpy(rng.integers(0, 64, (2, 4, 4)))
    inputs["continuations"] = torch.from_numpy(
        rng.integers(0, 64, (4, SIZE["T"] - 2, 4, 4)))
    torch.save({k: {"init": v["init"], "noise": v["noise"]}
                if isinstance(v, dict) else v for k, v in inputs.items()},
               tmp / "inputs.pt")
    return inputs


def random_tree(tree, seed):
    import jax
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if name.endswith("scale"):
            return (1.0 + 0.1 * rng.standard_normal(np.shape(leaf))).astype(
                np.float32)
        s = 0.05 if name.endswith("bias") else 0.1
        return (s * rng.standard_normal(np.shape(leaf))).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, tree)


def jax_noise(rng, shape, cfg):
    """The draws that `tpu1x.data.corruption.maskgit_corrupt` makes from
    `rng`, under the port's names (tests/test_torch_train.py's)."""
    import jax
    import jax.numpy as jnp
    from tpu1x_torch.data.corruption import NOISE_KEYS
    Bn, T, H_, W = shape
    F, V = cfg.num_factored_vocabs, cfg.factored_vocab_size
    k = jax.random.split(rng, 10)
    draws = (
        jax.random.uniform(k[0]),
        jax.random.uniform(k[1], (Bn, T, H_, W, F)),
        jax.random.randint(k[2], (Bn, T, H_, W, F), 0, V, dtype=jnp.int32),
        jax.random.uniform(k[3]),
        jax.random.randint(k[4], (), cfg.num_prompt_frames, T,
                           dtype=jnp.int32),
        jax.random.uniform(k[5], (), minval=0.25, maxval=1.0),
        jax.random.uniform(k[6], (T,), minval=0.9, maxval=1.0),
        jax.random.uniform(k[7], (Bn, T, H_, W, F)),
        jax.random.uniform(k[8], (Bn, T)),
        jax.random.uniform(k[9], (Bn, T, H_, W)))
    return {name: torch.from_numpy(np.array(d))
            for name, d in zip(NOISE_KEYS, draws)}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Every gloo group of the file, started at once: layout -> a function
    that waits for that group and returns its results."""
    tmp = tmp_path_factory.mktemp("tp")
    inputs = make_inputs(tmp)
    procs = {name: spawn([__file__, name, str(tmp)], dp * tp, ROOT)
             for name, (dp, tp, _) in LAYOUTS.items()}
    done = {}

    def result(name):
        if name not in done:
            finish(procs.pop(name))
            done[name] = torch.load(tmp / f"result_{name}.pt",
                                    weights_only=False)
        return done[name]
    yield SimpleNamespace(result=result, inputs=inputs, tmp=tmp)
    for ps in procs.values():
        for p in ps:
            p.kill()


@pytest.fixture(scope="module")
def one_process(groups):
    """(arch, layout) -> the same training in this process, at the layout's
    widths (metrics, parameters)."""
    done = {}

    def run(arch, layout):
        k = key(arch, layout)
        if k not in done:
            cfg = config(arch, layout)
            state = fresh_state(cfg, groups.inputs[k]["init"])
            done[k] = train(state, cfg, groups.inputs["batches"],
                            slice(None), groups.inputs[k]["noise"])[:2]
        return done[k]
    return run


def jax_first_update(inputs, arch, layout):
    """The JAX package's first update (two micro-steps) on the layout's dp x
    tp mesh of its virtual CPU devices, at its widths: the micro-batches'
    metrics and the parameters after, by the port's names."""
    import jax
    import jax.numpy as jnp
    from tpu1x.models.st_maskgit import STMaskGIT as JaxModel
    from tpu1x.parallel.mesh import batch_sharding, make_mesh
    from tpu1x.train.optim import build_optimizer
    from tpu1x.train.step import TrainState, make_train_step, \
        shard_train_state
    from tpu1x_torch.weights import params_from_jax
    dp, tp, _ = LAYOUTS[layout]
    jcfg = inputs[key(arch, layout)]["jcfg"]
    tx = build_optimizer(jcfg, **OPT)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    inputs[key(arch, layout)]["tree"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(params), rng=jax.random.PRNGKey(7))
    mesh = make_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    state, _ = shard_train_state(state, mesh)
    step = make_train_step(JaxModel(jcfg), tx, jcfg, donate=False)
    metrics = []
    for i in range(ACCUMULATE):
        tokens = jax.device_put(jnp.asarray(inputs["batches"][i].numpy(),
                                            jnp.int32), batch_sharding(mesh))
        state, m = step(state, tokens)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, params_from_jax(jax.device_get(state.params),
                                    config(arch, layout))


@pytest.fixture(scope="module")
def jax_runs(groups):
    done = {}

    def run(arch, layout):
        if (arch, layout) not in done:
            done[arch, layout] = jax_first_update(groups.inputs, arch, layout)
        return done[arch, layout]
    return run


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_training_equals_one_process(groups, one_process, layout, arch):
    got = groups.result(layout)[arch]
    want_metrics, want_params = one_process(arch, layout)
    assert len(got["metrics"]) == len(want_metrics) == UPDATES * ACCUMULATE
    for i, (a, b) in enumerate(zip(got["metrics"], want_metrics)):
        for key in ("loss", "acc", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5,
                                       err_msg=f"{layout} {key} {i}")
    for updates in range(1, UPDATES + 1):
        for name, v in want_params[updates].items():
            np.testing.assert_allclose(
                got["params"][updates][name].numpy(), v.numpy(), rtol=1e-5,
                atol=1e-8, err_msg=f"{layout} {name} after {updates}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_first_update_equals_jax_mesh_step(groups, jax_runs, layout,
                                              arch):
    jm, jparams = jax_runs(arch, layout)
    got = groups.result(layout)[arch]
    if arch == "pre_ln":
        assert jm[0]["grad_norm"] > 0.5  # the clip is active
    for a, b in zip(got["metrics"][:ACCUMULATE], jm):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5,
                                       err_msg=key)
    for name, v in jparams.items():
        np.testing.assert_allclose(got["params"][1][name].numpy(),
                                   v.numpy(), atol=5e-6, rtol=0,
                                   err_msg=name)


def test_tp_dropout_keeps_model_groups_equal(groups):
    got = groups.result("tp2")["dropout"]
    assert got == dict(params_agree=True, logits_agree=True,
                       differs_from_eval=True)


def test_tp_replicated_gradients_made_alike(groups):
    assert groups.result("tp2")["grads_part"] is True


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_rollout_over_the_mesh_equals_one_process(groups, temperature):
    from tpu1x_torch.rollout.engine import RolloutEngine
    inputs = groups.inputs
    cfg = config("pre_ln")
    engine = RolloutEngine(inputs["pre_ln"]["init"], cfg, device="cpu",
                           temperature=temperature)
    want = engine.rollout(inputs["prompt"], cfg.T - 2,
                          torch.Generator().manual_seed(5), num_futures=2)
    got = groups.result("tp2")["rollouts"][temperature]
    assert got.shape == want.shape == (2, 2, cfg.T, 4, 4)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if temperature > 0:  # the two futures of a prompt draw apart
        assert not torch.equal(got[:, 0], got[:, 1])


def test_scores_over_the_mesh_equal_one_process_and_jax(groups):
    import jax
    import jax.numpy as jnp
    from tpu1x.models.st_maskgit import STMaskGIT as JaxModel
    from tpu1x.parallel.mesh import make_mesh
    from tpu1x.rollout.engine import RolloutEngine as JaxRollout
    from tpu1x_torch.rollout.engine import RolloutEngine
    inputs = groups.inputs
    cfg = config("pre_ln")
    ctx, conts = inputs["context"], inputs["continuations"]
    want = RolloutEngine(inputs["pre_ln"]["init"], cfg, device="cpu") \
        .score_policies(ctx, conts)
    got = groups.result("tp2")["scores"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    jcfg = inputs["pre_ln"]["jcfg"]
    jengine = JaxRollout(JaxModel(jcfg), jax.tree_util.tree_map(
        jnp.asarray, inputs["pre_ln"]["tree"]), jcfg,
        mesh=make_mesh(dp=4, tp=2))
    jscores = jengine.score_policies(
        jnp.asarray(ctx.numpy(), jnp.int32),
        jnp.asarray(np.concatenate([conts.numpy()] * 2), jnp.int32))[:4]
    np.testing.assert_allclose(got.numpy(), np.asarray(jscores), rtol=1e-4)


def test_tp_fsdp_exports_and_checkpoint(groups):
    got = groups.result("dp2tp2_fsdp")["checkpoint"]
    assert got["bitwise"] and got["keys"] > 0 and got["split_keys"] > 0
    assert got["step"] == 2 * ACCUMULATE
    assert "--tp 2" in got["refused"] and "--tp 1" in got["refused"]
    from tpu1x_torch.models.st_maskgit import STMaskGIT
    cfg = config("pre_ln")
    want = groups.tmp / "export_one_process"
    model = STMaskGIT(cfg)
    model.load_state_dict(groups.inputs["pre_ln"]["init"])
    exports(model.state_dict(), cfg, want)
    for name in ("params.msgpack", "model.safetensors", "config.json"):
        assert (groups.tmp / "export_dp2tp2_fsdp" / name).read_bytes() == \
            (want / name).read_bytes(), name


def test_train_cli_tp2_two_processes_and_resume(tmp_path):
    from tpu1x_torch.data.token_store import write_token_dataset
    from tpu1x_torch.train import train as train_cli
    from tpu1x_torch.train.checkpoint import read_safetensors
    rng = np.random.RandomState(0)
    data = tmp_path / "data"
    write_token_dataset(data, rng.randint(0, 64, (60, 4, 4)).astype(
        np.uint32), vocab_size=64, segment_ids=np.zeros(60, np.int32))
    config("pre_ln", num_layers=1).save_pretrained(tmp_path / "config.json")

    def argv(out, *extra):
        return ["--train_data_dir", str(data), "--val_data_dir", str(data),
                "--genie_config", str(tmp_path / "config.json"),
                "--output_dir", str(out), "--window_size", "4", "--stride",
                "1", "--per_device_train_batch_size", "2",
                "--max_train_steps", "2", "--eval_every_n_steps", "2",
                "--max_eval_steps", "1", "--vis_every_n_steps", "100",
                "--checkpointing_steps", "1", "--learning_rate", "1e-3",
                "--device", "cpu", "--tp", "2", *extra]
    outs = finish(spawn(["-m", "tpu1x_torch.train.train",
                         *argv(tmp_path / "out")], 2, tmp_path))
    assert "'model': 2" in outs[0], outs[0][-2000:]
    out = tmp_path / "out"
    lines = [json.loads(x) for x in
             (out / "metrics.jsonl").read_text().splitlines()]
    assert any("train_loss" in x for x in lines)
    assert any("eval_loss" in x for x in lines)
    assert (out / "step_1" / ".metadata").exists()
    outs = finish(spawn(["-m", "tpu1x_torch.train.train", *argv(
        tmp_path / "resumed", "--resume_from_checkpoint",
        str(out / "step_1"))], 2, tmp_path))
    assert "resumed from step_1 at step 1" in outs[0]
    a = read_safetensors(out / "final_checkpt_hf" / "model.safetensors")
    b = read_safetensors(tmp_path / "resumed" / "final_checkpt_hf"
                         / "model.safetensors")
    assert set(a) == set(b)
    assert "decoder.layers.0.mlp.fc1.weight" in a
    assert a["decoder.layers.0.mlp.fc1.weight"].shape == (128, 32)
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
    with pytest.raises(ValueError, match="--tp 3"):
        train_cli.main(argv(tmp_path / "bad")[:-2] + ["--tp", "3"])


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2])
