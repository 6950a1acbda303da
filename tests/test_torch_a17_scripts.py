"""The developers' instruments of flash_vstream_tpu_torch/scripts/ (the
counterparts of scripts/bench_train_step.py, profile_ingest.py,
probe_ingest_fusion.py, bench_attention.py, sweep_attention_blocks.py,
probe_attn_crossover.py, bench_int8_matvec.py, probe_int4_matvec.py and
the three shell wrappers), run on the CPU at tiny sizes through their
`main()`: each prints the JSON line and the names it promises, with the
CPU named as the device (every time the host's, no device share). The
training step's FLOP reckoning equals the JAX script's at the 2B and 7B
shapes (1e-12 relative). Each wrapper passes `bash -n`, names only
modules of the port that exist, and its flags parse with that module's
parser."""
import argparse
import importlib
import importlib.util
import json
import pathlib
import re
import shlex
import subprocess

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "flash_vstream_tpu_torch" / "scripts"
CPU = "cpu (no card: every time below is the host's)"


def _last_json(capsys):
    out = capsys.readouterr()
    line = [ln for ln in out.out.splitlines() if ln.startswith("{")][-1]
    return json.loads(line), out.err


def test_bench_train_step_tiny(capsys):
    from flash_vstream_tpu_torch.scripts import bench_train_step
    bench_train_step.main(["--tiny", "--device", "cpu", "--steps", "2",
                           "--seq", "128", "--frames", "8", "--accum", "2",
                           "--mlp-chunk", "32", "--lora-rank", "4"])
    out, _ = _last_json(capsys)
    assert out["metric"] == "torch_train_step_2b_lora"
    assert out["device"] == CPU and out["share_of_h100_bf16_peak"] is None
    for k in ("step_p50_s", "tokens_per_s", "model_tflop_per_step",
              "achieved_tflops", "flop_split_tflop", "first_step_s",
              "final_loss", "peak_memory_gib"):
        assert k in out, k
    assert out["grad_accum"] == 2 and len(out["steps_s"]) == 2
    assert out["final_loss"] == out["final_loss"]        # finite, not nan


@pytest.mark.parametrize("arch", ["2b", "7b"])
def test_train_step_flops_match_jax_script(arch):
    spec = importlib.util.spec_from_file_location(
        "jax_bench_train_step", ROOT / "scripts" / "bench_train_step.py")
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    from flash_vstream_tpu_torch.scripts import bench_train_step
    args = bench_train_step.make_parser().parse_args(["--arch", arch])
    cfg = bench_train_step.make_config(args)
    for frames, seq, px in ((16, 512, 224), (240, 14000, 448)):
        got = bench_train_step.train_step_model_flops(cfg, frames, seq, px)
        want = jax_script.train_step_model_flops(cfg, frames, seq, px, 0)
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_profile_ingest_tiny(capsys):
    from flash_vstream_tpu_torch.scripts import profile_ingest
    profile_ingest.main(["--device", "cpu", "--side", "56", "--layers", "1",
                         "--iters", "2", "--trials", "1", "--int8-vit"])
    out, err = _last_json(capsys)
    assert out["metric"] == "torch_ingest_profile" and out["device"] == CPU
    for k in ("preprocess", "vit", "memory_update", "merger", "full",
              "previt", "vitmem"):
        assert out[f"{k}_ms"] is None          # no replay on the CPU
        assert out[f"{k}_eager_ms"] > 0, k
    for label in ("device preprocess", "ViT encode (dual-res)",
                  "flash memory update", "patch merger (full memory)",
                  "FULL ingest (pre+vit+mem)", "graph n/a"):
        assert label in err, label


def test_probe_ingest_fusion_tiny(capsys):
    from flash_vstream_tpu_torch.scripts import probe_ingest_fusion
    probe_ingest_fusion.main(["--device", "cpu", "--side", "56", "--layers",
                              "1", "--iters", "2", "--trials", "1"])
    out, _ = _last_json(capsys)
    assert out["metric"] == "torch_ingest_fusion"
    assert set(out) >= {"pre+vit", "pre+vit+mem", "pre+vit+mem (+state out)",
                        "full (pre+vit+mem+merge)", "merger alone"}
    assert all(out[k]["eager_ms"] > 0 for k in ("pre+vit", "merger alone"))


def test_bench_attention_tiny(capsys):
    from flash_vstream_tpu_torch.scripts import bench_attention
    bench_attention.main(["--device", "cpu", "--seq", "64", "--heads", "2",
                          "--kv-heads", "1", "--dim", "64", "--iters", "1",
                          "--trials", "1", "--calib-size", "64"])
    out, _ = _last_json(capsys)
    assert out["metric"] == "torch_flash_attention_tflops"
    assert out["shape"] == "B1 H2/1 S64 D64 bf16 causal"
    for k in ("fwd_tflops", "fwd_bwd_tflops", "sdpa_fwd_tflops",
              "sdpa_fwd_bwd_tflops", "matmul_calibration_tflops"):
        assert out[k] > 0, k


def test_sweep_attention_blocks_tiny(capsys):
    from flash_vstream_tpu_torch.kernels.flash_attention import (
        ROWS_PER_BLOCK, _launch_plan)
    from flash_vstream_tpu_torch.scripts import sweep_attention_blocks
    sweep_attention_blocks.main(["--device", "cpu", "--seq", "64",
                                 "--heads", "2", "--dim", "64", "--iters",
                                 "1", "--trials", "1"])
    out, _ = _last_json(capsys)
    assert out["metric"] == "torch_flash_attention_fwd_plan_sweep"
    own = _launch_plan(1, 2, 64, 64).rows_per_block
    assert set(out["plans"]) == {*map(str, ROWS_PER_BLOCK), f"plan({own})"}
    for rows in ROWS_PER_BLOCK:
        p = out["plans"][str(rows)]
        assert p["rows_per_block"] == rows
        assert p["blocks"] == 2 * -(-64 // rows)


def test_probe_attn_crossover_tiny(capsys):
    from flash_vstream_tpu_torch.scripts import probe_attn_crossover
    probe_attn_crossover.main(["--device", "cpu", "--cases",
                               "1:2:32:64:0,1:2:64:64:0,1:2:64:80:1",
                               "--iters", "2", "--trials", "1"])
    out, err = _last_json(capsys)
    assert out["metric"] == "torch_attention_crossover"
    assert set(out["k1_faster_from_s"]) == {"D64", "D80c"}
    assert {"B1xH2xS32xD64:k1", "B1xH2xS64xD80c:plain"} <= set(out["us"])
    assert out["jax_worth_fusing_s"] == 512 and "K1 faster from S" in err


def test_bench_int8_matvec_tiny(capsys):
    from flash_vstream_tpu_torch.scripts import bench_int8_matvec
    bench_int8_matvec.main(["--device", "cpu", "--dims", "qkvo:64:96",
                            "--iters", "2", "--trials", "1"])
    out, _ = _last_json(capsys)
    assert out["metric"] == "torch_int8_matvec" and out["rows"] == 8
    row = out["qkvo"]
    assert row["bf16_share_of_hbm"] is None and row["int8_gbs"] > 0
    assert {"bf16_us", "int8_us", "speedup"} <= set(row)
    assert [s[0] for s in bench_int8_matvec.SHAPES] == ["qkvo", "gate_up",
                                                         "down"]


def test_probe_int4_matvec_tiny(capsys):
    from flash_vstream_tpu_torch.scripts import probe_int4_matvec
    probe_int4_matvec.main(["--device", "cpu", "--din", "256", "--dout",
                            "384", "--layers", "2", "--iters", "2",
                            "--trials", "1"])
    out, _ = _last_json(capsys)
    assert out["metric"] == "torch_int4_matvec"
    assert set(out) >= {"bf16", "int8", "int4_dequant"}
    assert "int4_k6" not in out          # the kernel runs on the card only
    assert all(out[k]["gbs"] > 0 and out[k]["share_of_hbm"] is None
               for k in ("bf16", "int8", "int4_dequant"))


WRAPPERS = ("realtime_cli.sh", "train_and_eval_qwen.sh",
            "train_and_eval_llava.sh")


def _words(args: str):
    """A command's words, each shell variable taken as 1 (a valid path,
    name and count alike)."""
    return shlex.split(re.sub(r"\$\{?\w+\}?", "1", args))


def _commands(text: str):
    """(module, argv) of each `python -m` / `$RUN -m` line, continuation
    lines joined and shell variables taken as 1."""
    body = re.sub(r"\\\n\s*", " ", text)
    for line in body.splitlines():
        m = re.search(r"(?:python|\$RUN)\s.*?-m\s+(flash_vstream\S+)\s*(.*)",
                      line)
        if m:
            yield m.group(1), _words(m.group(2))


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_syntax_and_modules(name):
    path = SCRIPTS / name
    subprocess.run(["bash", "-n", str(path)], check=True)
    text = path.read_text()
    assert "flash_vstream_tpu." not in text.replace(
        "flash_vstream_tpu_torch.", "")
    cmds = list(_commands(text))
    assert cmds, name
    for module, argv in cmds:
        assert module.startswith("flash_vstream_tpu_torch."), module
        assert importlib.util.find_spec(module) is not None, module
        mod = importlib.import_module(module)
        parser = getattr(mod, "make_parser", None)
        if parser is None:            # eval_any_dataset_features: main()
            src = pathlib.Path(mod.__file__).read_text()
            for flag in (a for a in argv if a.startswith("--")):
                assert f'"{flag}"' in src, (module, flag)
            continue
        parser().parse_args(argv)


def test_wrappers_mirror_the_jax_ones():
    """Each wrapper runs the JAX original's recipe: the same flags and
    values, module for module, with the port's package in place of the
    JAX one."""
    for name in WRAPPERS:
        ours = list(_commands((SCRIPTS / name).read_text()))
        theirs = [(m.replace("flash_vstream_tpu.",
                             "flash_vstream_tpu_torch."), a) for m, a in
                  _commands_jax((ROOT / "scripts" / name).read_text())]
        assert ours == theirs, name


def _commands_jax(text):
    body = re.sub(r"\\\n\s*", " ", text)
    for line in body.splitlines():
        m = re.search(r"python\s+-m\s+(flash_vstream_tpu\.\S+)\s*(.*)", line)
        if m:
            yield m.group(1), _words(m.group(2))


def test_parser_sets_match_jax_scripts():
    """Every instrument keeps its JAX script's flags (those that mean
    something here; `--memory-analysis`, an XLA estimate, is measured
    instead; the Pallas sweep's block pairs are K1's --rows)."""
    dropped = {"bench_train_step": {"--memory-analysis"},
               # Pallas's (block_q, block_kv) become K1's rows per block
               "sweep_attention_blocks": {"--configs"}}
    for name in ("bench_train_step", "profile_ingest", "probe_ingest_fusion",
                 "bench_attention", "sweep_attention_blocks",
                 "probe_attn_crossover", "bench_int8_matvec",
                 "probe_int4_matvec"):
        src = (ROOT / "scripts" / f"{name}.py").read_text()
        theirs = set(re.findall(r'add_argument\(\s*"(--[\w-]+)"', src))
        mod = importlib.import_module(
            f"flash_vstream_tpu_torch.scripts.{name}")
        ours = {o for a in mod.make_parser()._actions
                for o in a.option_strings if o.startswith("--")}
        missing = theirs - ours - dropped.get(name, set())
        assert not missing, (name, missing)
        assert isinstance(mod.make_parser(), argparse.ArgumentParser)
