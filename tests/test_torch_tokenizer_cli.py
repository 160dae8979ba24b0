"""The port's tokenize, visualize, evaluate and train CLIs with the MAGVIT2
tokenizer and LPIPS, against the JAX package's, on the CPU.

One fresh interpreter runs the JAX side (in-process JAX and torch
convolutions have segfaulted in this suite): it writes a tiny tokenizer
checkpoint (32 px, 4x4 latents, vocab 64, fp32; weights drawn with numpy)
and a tiny GENIE checkpoint (genie_tiny, T = 4), runs the JAX tokenize CLI
on two segments of frames, `decode_latents_wrapper` on token frames, and
the JAX evaluate CLI with `--tokenizer_ckpt` and `--lpips_ckpt random` at
temperature 0 and maskgit_steps 1 (where no random draw decides a token),
and saves its random LPIPS weights in flax's msgpack form. The port's CLIs
run here with `--device cpu` on the same files: the tokenize CLI's
`video.bin` byte for byte, the decoded frames (uint8 after truncation:
within one level, equal on all but 0.1%), the evaluate CLI's loss and
accuracy (rtol 1e-5) and `pred_lpips` (rtol 1e-3: a frame level flipped by
the truncation moves it) with the JAX LPIPS weights, its `dec_time`; the
visualize CLI's GIF and comic, and the train CLI's decoded figure and
train-time LPIPS.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu1x.eval import visualize as jax_vis
from tpu1x_torch import kernels
from tpu1x_torch.config import VQConfig
from tpu1x_torch.data.token_store import RawTokenDataset, write_token_dataset
from tpu1x_torch.eval import evaluate as ev_cli
from tpu1x_torch.eval import visualize
from tpu1x_torch.eval.evaluate import GenieEvaluator, evaluate_dataset
from tpu1x_torch.eval.metrics import make_lpips_fn
from tpu1x_torch.model_zoo import genie_tiny
from tpu1x_torch.tokenizer import tokenize
from tpu1x_torch.tokenizer.checkpoint import load_tokenizer
from tpu1x_torch.tokenizer.vqmodel import VQModel
from tpu1x_torch.train import train as train_cli

ROOT = Path(__file__).resolve().parent.parent
torch.set_num_threads(2)
EVAL_ARGS = ["--window_size", "4", "--stride", "1", "--batch_size", "2",
             "--max_examples", "3", "--maskgit_steps", "1",
             "--temperature", "0"]

CHILD = r"""
import contextlib, io, json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import flax.serialization
import numpy as np
from pathlib import Path
from tpu1x.config import VQConfig
from tpu1x.eval import evaluate
from tpu1x.eval.visualize import decode_latents_wrapper
from tpu1x.model_zoo import genie_tiny
from tpu1x.models.st_maskgit import STMaskGIT
from tpu1x.tokenizer import tokenize
from tpu1x.tokenizer.checkpoint import save_tokenizer
from tpu1x.tokenizer.lpips import LPIPS, resolve_lpips_params
from tpu1x.tokenizer.vqmodel import VQModel
from tpu1x.train.checkpoint import save_pretrained

work = Path(sys.argv[1])
eval_args = json.loads(sys.argv[2])
rng = np.random.default_rng(0)

def draw(path, leaf):
    name = "/".join(str(getattr(k, "key", k)) for k in path)
    shape = np.shape(leaf)
    if name.endswith("kernel") and len(shape) == 4:
        return (rng.standard_normal(shape)
                / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
    if name.endswith("scale"):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    s = (0.3 if "out_x_proj" in name else 1.0 if "embed" in name
         else 0.05 if name.endswith("bias") else 0.1)
    return (s * rng.standard_normal(shape)).astype(np.float32)

vq_cfg = VQConfig(resolution=32, base_channels=32, ch_mult=(1, 1, 2, 2),
                  num_res_blocks=1, z_channels=6, codebook_size=64,
                  dtype="float32")
tree = VQModel(vq_cfg).init(jax.random.PRNGKey(0),
                            np.zeros((1, 32, 32, 3), np.float32))["params"]
save_tokenizer(work / "tok", jax.tree_util.tree_map_with_path(
    draw, jax.device_get(tree)), vq_cfg)

cfg = genie_tiny(T=4)
dummy = np.zeros((1, cfg.T * cfg.S), np.int32)
tree = STMaskGIT(cfg).init(jax.random.PRNGKey(0), dummy, dummy)["params"]
save_pretrained(work / "genie", jax.tree_util.tree_map_with_path(
    draw, jax.device_get(tree)), cfg)

sys.argv = ["x", "--frames", str(work / "frames"), "--tokenizer_ckpt",
            str(work / "tok"), "--output_dir", str(work / "jax_tokens"),
            "--batch_size", "3"]
tokenize.main()
out = {"decoded": decode_latents_wrapper(str(work / "tok"), batch_size=3)(
    np.load(work / "ids.npy"))}

sys.argv = ["x", "--val_data_dir", str(work / "data"), "--checkpoint_dir",
            str(work / "genie"), "--tokenizer_ckpt", str(work / "tok"),
            "--lpips_ckpt", "random"] + eval_args
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    evaluate.main()
(work / "jax_eval.json").write_text(buf.getvalue().strip().splitlines()[-1])
rand = resolve_lpips_params(LPIPS(net="alex"), "random", "alex")
(work / "random_alex.msgpack").write_bytes(flax.serialization.to_bytes(rand))
np.savez(work / "out.npz", **out)
print("child done")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    work = tmp_path_factory.mktemp("tokenizer_cli")
    rng = np.random.default_rng(1)
    (work / "frames").mkdir()
    for seg in range(2):
        np.save(work / "frames" / f"clip_{seg}.npy",
                rng.integers(0, 256, (5, 32, 32, 3)).astype(np.uint8))
    np.save(work / "ids.npy", rng.integers(0, 64, (5, 4, 4)).astype(np.int32))
    write_token_dataset(work / "data", rng.integers(0, 64, (80, 4, 4)),
                        vocab_size=64, segment_ids=np.zeros(80, np.int32))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", CHILD, str(work), json.dumps(EVAL_ARGS)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    return dict(work=work, out=dict(np.load(work / "out.npz")),
                jax_eval=json.loads((work / "jax_eval.json").read_text()))


@pytest.fixture(autouse=True)
def no_launches():
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


def run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().strip().splitlines()


def tok_model(ref):
    state, cfg = load_tokenizer(ref["work"] / "tok")
    model = VQModel(cfg)
    model.load_state_dict(state)
    return model


def test_tokenize_cli_writes_the_jax_dataset_byte_for_byte(ref):
    work = ref["work"]
    lines = run(tokenize.main, [
        "--frames", str(work / "frames"), "--tokenizer_ckpt",
        str(work / "tok"), "--output_dir", str(work / "port_tokens"),
        "--batch_size", "3", "--device", "cpu"])
    assert lines[-1].startswith("wrote 10 token frames")
    for name in ("video.bin", "segment_ids.bin"):
        assert (work / "port_tokens" / name).read_bytes() == (
            work / "jax_tokens" / name).read_bytes(), name
    meta = json.loads((work / "port_tokens" / "metadata.json").read_text())
    assert meta == json.loads((work / "jax_tokens" / "metadata.json").read_text())
    assert meta["vocab_size"] == 64 and meta["num_images"] == 10
    ds = RawTokenDataset(work / "port_tokens", window_size=3, stride=1)
    assert len(ds) == 2 * (5 - 3 + 1)  # no window crosses the segments


def test_encode_frames_pads_the_tail_batch(ref):
    model = tok_model(ref)
    frames = np.load(ref["work"] / "frames" / "clip_0.npy")
    by3 = tokenize.encode_frames(model, frames, batch_size=3, device="cpu")
    by16 = tokenize.encode_frames(model, frames, batch_size=16, device="cpu")
    assert by3.shape == (5, 4, 4) and by3.dtype == np.int32
    np.testing.assert_array_equal(by3, by16)
    names = [name for name, _ in tokenize.load_frames(ref["work"] / "frames")]
    assert names == ["clip_0", "clip_1"]


def test_decode_latents_wrapper_matches_jax(ref):
    fn = visualize.decode_latents_wrapper(str(ref["work"] / "tok"),
                                          batch_size=3, device="cpu")
    got = fn(np.load(ref["work"] / "ids.npy"))
    want = ref["out"]["decoded"]
    assert got.shape == want.shape == (5, 32, 32, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_decode_latents_wrapper_without_checkpoint_warns():
    cfg = VQConfig(resolution=32, base_channels=32, ch_mult=(1, 2),
                   num_res_blocks=1, z_channels=6, codebook_size=64)
    with pytest.warns(UserWarning, match="RANDOMLY"):
        fn = visualize.decode_latents_wrapper(config=cfg, device="cpu")
    out = fn(np.zeros((2, 16, 16), np.int32))
    assert out.shape == (2, 32, 32, 3) and out.dtype == np.uint8


def test_visualize_cli_writes_gif_and_comic(ref, tmp_path):
    from PIL import Image
    stream = np.load(ref["work"] / "ids.npy")[:5]
    write_token_dataset(tmp_path / "gen", np.concatenate([stream, stream[:1]]),
                        vocab_size=64, extra_metadata={
                            "num_prompt_frames": 2, "window_size": 4})
    lines = run(visualize.main, [
        "--token_dir", str(tmp_path / "gen"), "--tokenizer_ckpt",
        str(ref["work"] / "tok"), "--device", "cpu"])
    assert lines[-1] == f"wrote {tmp_path / 'gen' / 'vis'}.gif"
    gif = Image.open(tmp_path / "gen" / "vis.gif")
    assert gif.n_frames == 6 and gif.size == (32, 32 + 24)
    comic = np.asarray(Image.open(tmp_path / "gen" / "vis_comic.png"))
    assert comic.shape == (2 * (32 + 24), 4 * 32, 3)


def test_make_comic_and_captions_match_jax():
    frames = np.random.default_rng(2).integers(
        0, 256, (7, 32, 32, 3)).astype(np.uint8)
    np.testing.assert_array_equal(visualize.make_comic(frames, 3, 5),
                                  jax_vis.make_comic(frames, 3, 5))
    for i in range(7):
        assert (visualize.caption_for_frame(i, 3, 5)
                == jax_vis.caption_for_frame(i, 3, 5))
    np.testing.assert_array_equal(visualize.caption_image(frames[0], "Prompt"),
                                  jax_vis.caption_image(frames[0], "Prompt"))


def eval_argv(ref, lpips_ckpt):
    work = ref["work"]
    return ["--val_data_dir", str(work / "data"), "--checkpoint_dir",
            str(work / "genie"), "--tokenizer_ckpt", str(work / "tok"),
            "--lpips_ckpt", lpips_ckpt, "--device", "cpu"] + EVAL_ARGS


def test_evaluate_cli_frame_metrics_match_jax(ref):
    got = json.loads(run(ev_cli.main, eval_argv(
        ref, str(ref["work"] / "random_alex.msgpack")))[-1])
    want = ref["jax_eval"]
    assert set(got) == set(want) == {"loss", "acc", "gen_time", "dec_time",
                                     "pred_lpips", "count"}
    assert got["count"] == want["count"] == 3
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["acc"] == want["acc"]
    np.testing.assert_allclose(got["pred_lpips"], want["pred_lpips"],
                               rtol=1e-3)
    assert got["dec_time"] > 0


def test_evaluate_cli_with_random_lpips(ref):
    with pytest.warns(UserWarning, match="RANDOM"):
        got = json.loads(run(ev_cli.main, eval_argv(ref, "random"))[-1])
    assert np.isfinite(got["pred_lpips"]) and got["pred_lpips"] > 0
    assert got["dec_time"] > 0 and got["count"] == 3


def test_evaluate_dataset_frame_outputs_and_empty_metrics(ref, tmp_path):
    state, cfg = ev_cli.load_model_checkpoint(ref["work"] / "genie")
    ev = GenieEvaluator(state, cfg, device="cpu", maskgit_steps=1)
    ds = RawTokenDataset(ref["work"] / "data", window_size=4, stride=1,
                         filter_overlaps=True)
    plain = evaluate_dataset(ev, ds, batch_size=2, max_examples=3,
                             verbose=False)
    assert set(plain) == {"loss", "acc", "gen_time", "count"}
    decode = visualize.decode_latents_wrapper(str(ref["work"] / "tok"),
                                              device="cpu")
    lpips_fn = make_lpips_fn(str(ref["work"] / "random_alex.msgpack"),
                             device="cpu")
    out = evaluate_dataset(ev, ds, batch_size=2, max_examples=3,
                           decode_latents=decode, lpips_fn=lpips_fn,
                           save_outputs_dir=str(tmp_path), verbose=False)
    assert out["loss"] == pytest.approx(plain["loss"], rel=1e-6)
    for name in ("pred_frames", "gtruth_frames"):
        frames = np.load(tmp_path / f"{name}.npy")
        assert frames.shape == (3, 3, 32, 32, 3) and frames.dtype == np.uint8
    gt = np.load(tmp_path / "gtruth_frames.npy")
    want = decode(ds.get_batch(np.arange(3))[:, 1:].reshape(-1, 4, 4))
    np.testing.assert_array_equal(gt.reshape(want.shape), want)
    np.testing.assert_allclose(out["pred_lpips"], lpips_fn(
        gt, np.load(tmp_path / "pred_frames.npy")).mean(), rtol=1e-6)


def test_train_cli_decodes_figures_and_logs_lpips(ref, tmp_path):
    genie_tiny(num_layers=1, d_model=16, num_prompt_frames=2).save_pretrained(
        tmp_path / "config.json")
    data = str(ref["work"] / "data")
    argv = ["--train_data_dir", data, "--val_data_dir", data,
            "--genie_config", str(tmp_path / "config.json"), "--output_dir",
            str(tmp_path / "out"), "--window_size", "4", "--stride", "1",
            "--per_device_train_batch_size", "2", "--max_train_steps", "2",
            "--vis_every_n_steps", "2", "--eval_every_n_steps", "10",
            "--tokenizer_ckpt", str(ref["work"] / "tok"), "--lpips_ckpt",
            "random", "--device", "cpu"]
    with pytest.warns(UserWarning, match="RANDOM"):
        lines = run(train_cli.main, argv)
    assert any(x.startswith("step 2 train-time lpips") for x in lines), lines
    assert not any("visualization failed" in x for x in lines)
    from PIL import Image
    grid = np.asarray(Image.open(tmp_path / "out" / "vis_step_2"
                                 / "pred_vs_gtruth.png"))
    assert grid.shape == (4 * 2 * 32, 2 * 32, 3)
    logged = [json.loads(x) for x in
              (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()]
    assert any("lpips" in x and x["step"] == 2 for x in logged)
