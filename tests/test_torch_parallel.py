"""Data parallelism of the port on the CPU: two gloo processes, each its own
interpreter with a timeout, train a tiny fp32 qk_norm model (whose blocks
remat recomputes, the default "attn_outs") under DDP and under FSDP2
(`shard_train_state`) for three updates of two micro-batches each,
every rank on its rows of each global batch. One process here trains the
same model on the global batches. Held to each other after 2 and after 3
updates: the loss, accuracy and gradient norm of every micro-batch and
every parameter, within rtol 1e-5 (atol 1e-8 for values near 0): fp32,
the ranks' sums run in another order. AdamW's eps is 1e-3, above every
gradient element, so that the update is linear in the gradient: with the
usual 1e-8 AdamW divides each element by the root of its own second
moment, and an element whose gradients nearly cancel carries its relative
rounding (up to 2e-3 here, though the gradients agree to 6e-7 in norm)
into its move whatever its size. The DDP run joins its group through the
JAX trainer's `TPU1X_MULTIHOST` variables, the FSDP2 run through
torchrun's; in both the ranks' dropout generators draw apart. The FSDP2
run also saves its sharded state after update 2 (each rank its shards and
its dropout generator) and restores it into a fresh sharded state, bit
for bit.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SIZE = dict(T=4, num_prompt_frames=2, num_heads=2, d_model=32)
WORLD, GLOBAL_B, ACCUMULATE, UPDATES, LR = 2, 4, 2, 3, 1e-2
TIMEOUT = 240


def setup():
    """The model, optimizer and generator every run starts from, and the
    global batches."""
    from tpu1x_torch.model_zoo import genie_tiny
    from tpu1x_torch.models.st_maskgit import STMaskGIT
    from tpu1x_torch.train.optim import TrainOptimizer
    from tpu1x_torch.train.step import TrainState
    torch.set_num_threads(1)
    # qk_norm: the op-by-op path, which remat recomputes in the backward
    cfg = genie_tiny(**SIZE, qk_norm=True)
    model = STMaskGIT(cfg).init_weights(torch.Generator().manual_seed(0))
    opt = TrainOptimizer(model, cfg, learning_rate=LR, weight_decay=0.1,
                         eps=1e-3,
                         max_grad_norm=0.5, lr_scheduler_type="cosine",
                         num_warmup_steps=1, num_training_steps=UPDATES,
                         gradient_accumulation_steps=ACCUMULATE)
    rng = np.random.default_rng(1)
    batches = [torch.from_numpy(rng.integers(
        0, cfg.image_vocab_size, (GLOBAL_B, cfg.T, 4, 4)))
        for _ in range(UPDATES * ACCUMULATE)]
    return cfg, TrainState(0, model, opt, torch.Generator().manual_seed(1)), \
        batches


def train(state, cfg, batches, rows, on_update=None):
    """Every micro-batch's metrics, the whole parameters after each update
    from the second on, and the step's state."""
    from tpu1x_torch.parallel.sharding import full_state_dict
    from tpu1x_torch.train.step import make_train_step
    step = make_train_step(state.model, state.optimizer, cfg, device="cpu",
                           generator=state.generator)
    metrics, params = [], {}
    for batch in batches:
        m = step(batch[rows])
        metrics.append({k: float(v) for k, v in m.items()})
        updates = step.state.optimizer.updates
        if step.state.optimizer.micro == 0 and updates >= 2:
            params[updates] = {k: v.clone() for k, v in
                               full_state_dict(step.state.model).items()}
            if on_update is not None:
                on_update(step.state, updates)
    return metrics, params, step.state


def worker(mode: str, out: str):
    """One rank: train under `mode` ("ddp" or "fsdp"); rank 0 writes the
    results to `out`."""
    import torch.distributed as dist

    from tpu1x_torch.parallel import mesh
    from tpu1x_torch.train.checkpoint import Checkpointer, _state_tensors
    from tpu1x_torch.train.step import make_train_step, shard_train_state
    assert mesh.init_distributed("cpu")
    cfg, state, batches = setup()
    state = shard_train_state(state, "cpu", fsdp=mode == "fsdp")
    saved = {}
    ckpt = Checkpointer(Path(out).parent / "ckpt")

    def on_update(s, updates):
        if mode == "fsdp" and updates == 2:
            ckpt.save(s, "step_2", wait=True)
            saved.update({k: v.to_local().clone() if hasattr(v, "to_local")
                          else v.clone()
                          for k, v in _state_tensors(s).items()})
    metrics, params, state = train(state, cfg, batches,
                                   mesh.local_rows(GLOBAL_B), on_update)
    # each rank drops with a generator of its own
    draws = [torch.empty(4) for _ in range(WORLD)]
    dist.all_gather(draws, torch.rand(4, generator=state.dropout_generator))
    result = {"metrics": metrics, "params": params,
              "world": mesh.process_count(),
              "dropout_draws_differ": not torch.equal(draws[0], draws[1])}
    if mode == "fsdp":
        _, fresh, _ = setup()
        fresh = shard_train_state(fresh, "cpu", fsdp=True)
        fresh = make_train_step(fresh.model, fresh.optimizer, cfg,
                                device="cpu", generator=fresh.generator).state
        ckpt.restore("step_2", fresh)
        got = {k: v.to_local() if hasattr(v, "to_local") else v
               for k, v in _state_tensors(fresh).items()}
        same = torch.tensor(int(set(got) == set(saved) and all(
            torch.equal(got[k], v) for k, v in saved.items())))
        dist.all_reduce(same, op=dist.ReduceOp.MIN)
        result.update(restored_bitwise=bool(same), restored_keys=len(got),
                      restored_step=fresh.step)
    if mesh.process_index() == 0:
        torch.save(result, out)
    dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(mode, tmp_path):
    port = free_port()
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS="1")
        if mode == "ddp":  # the JAX trainer's variables
            env.update(TPU1X_MULTIHOST="1",
                       TPU1X_COORDINATOR=f"localhost:{port}",
                       TPU1X_NUM_PROCESSES=str(WORLD),
                       TPU1X_PROCESS_ID=str(rank))
        else:  # torchrun's
            env.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                       LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, mode, str(tmp_path / "result.pt")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
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
    return torch.load(tmp_path / "result.pt", weights_only=False)


@pytest.fixture(scope="module")
def reference():
    cfg, state, batches = setup()
    return train(state, cfg, batches, slice(None))[:2]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """mode -> the two-process run's results, each run once."""
    done = {}

    def run(mode):
        if mode not in done:
            done[mode] = launch(mode, tmp_path_factory.mktemp(mode))
        return done[mode]
    return run


@pytest.mark.parametrize("updates", [2, 3])
@pytest.mark.parametrize("mode", ["ddp", "fsdp"])
def test_parallel_equals_one_process(runs, reference, mode, updates):
    got = runs(mode)
    want_metrics, want_params = reference
    assert got["world"] == WORLD and got["dropout_draws_differ"]
    n = updates * ACCUMULATE
    for a, b in zip(got["metrics"][:n], want_metrics[:n]):
        for key in ("loss", "acc", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5,
                                       err_msg=f"{mode} {key}")
    for name, v in want_params[updates].items():
        np.testing.assert_allclose(got["params"][updates][name].numpy(),
                                   v.numpy(), rtol=1e-5, atol=1e-8,
                                   err_msg=f"{mode} {name}")


def test_fsdp_checkpoint_round_trip(runs):
    got = runs("fsdp")
    assert got["restored_bitwise"] and got["restored_keys"] > 0
    assert got["restored_step"] == 2 * ACCUMULATE


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2])
