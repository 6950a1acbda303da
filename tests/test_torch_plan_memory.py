"""The port's full-7B memory plan (flash_vstream_tpu_torch/scripts/
plan_full7b_memory.py) at --tiny: for (dp, tp) in (2, 1), (2, 2) and
(4, 1), each rank's bytes of the parameters (ZeRO 3: at rest sharded) and
of Adam's mu and nu (the trained leaves: all but the vision tower) equal
the sum of JAX's shard shapes under `zero_shardings` on create_mesh(dp,
tp), leaf dtype by leaf dtype; at world 2 (dp 2 x tp 1 and dp 1 x tp 2,
in gloo ranks) they equal what a Trainer rank of the same recipe actually
holds. The script's main prints one JSON row a mesh."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from flash_vstream_tpu.core.config import tiny_llava_config as jtiny
from flash_vstream_tpu.models import vstream_llava as jvl
from flash_vstream_tpu.parallel.sharding import create_mesh, zero_shardings
from flash_vstream_tpu_torch.core.config import tiny_llava_config
from flash_vstream_tpu_torch.parallel.collectives import spawn
from flash_vstream_tpu_torch.scripts import plan_full7b_memory as plan

MESHES = [(2, 1), (2, 2), (4, 1)]
KEYS = ("params_bytes", "mu_bytes", "nu_bytes")


def _jax_bytes(dp, tp):
    shapes = jax.eval_shape(lambda k: jvl.init_llava_params(
        k, jtiny(), dtype=jnp.bfloat16), jax.random.PRNGKey(0))
    specs = zero_shardings(create_mesh(dp=dp, tp=tp), shapes)
    params = trained = 0
    for (path, x), s in zip(jax.tree_util.tree_leaves_with_path(shapes),
                            jax.tree.leaves(specs)):
        n = int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
        params += n
        if not jax.tree_util.keystr(path).startswith("['vit']"):
            trained += n
    return dict(params_bytes=params, mu_bytes=trained, nu_bytes=trained)


def _row(dp, tp):
    return plan.plan(tiny_llava_config(), dp, tp, seq=128, frames=8)


@pytest.mark.parametrize("mesh", MESHES)
def test_plan_matches_jax_shard_shapes(mesh):
    row, want = _row(*mesh), _jax_bytes(*mesh)
    assert {k: row[k] for k in KEYS} == want
    assert row["ranks"] == mesh[0] * mesh[1] and row["fits_80gb"]


def test_plan_matches_a_trainer_rank(tmp_path):
    spawn(torch_ranks.trainer_bytes, 2, str(tmp_path), [1, 2],
          init_file=str(tmp_path / "init"))
    for r in range(2):
        for held in torch.load(tmp_path / f"rank{r}.pt"):
            row = _row(held["dp"], held["tp"])
            assert {k: held[k] for k in KEYS} == {k: row[k] for k in KEYS}


def test_main_prints_a_row_a_mesh(capsys):
    rows = plan.main(["--tiny", "--mesh", "1", "2", "--tp", "2"])
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert printed == rows and [r["ranks"] for r in rows] == [2, 4]
    # the split halves what a rank holds of the split leaves
    assert rows[1]["params_bytes"] < rows[0]["params_bytes"]
