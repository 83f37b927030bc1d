"""The parts of chip_smoke.py that run on the CPU: the device phase refuses
it, the integer action rule, the bit-for-bit comparison, the rollout
invariants, the CPU reference writer and the golden replay."""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from tile_match_tpu.baseline_configs import CONFIGS
from tile_match_tpu.config import EnvConfig

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_phase_refuses_the_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu()
    assert "needs a GPU" in str(e.value)


def test_main_on_the_cpu_exits_without_a_result(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_in_a_directory_fails(tmp_path):
    shutil.copy(os.path.join(_ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("density", [0.0, 0.02, 0.3, 1.0])
def test_integer_rule_picks_only_effective_actions(density):
    rng = np.random.default_rng(int(density * 100))
    mask = rng.random((64, 40)) < density
    mask[0] = False
    mask[1] = False
    mask[1, 39] = True
    for i in range(4):
        acts = np.asarray(
            chip_smoke.uniform_effective_actions(jax.random.PRNGKey(i), jnp.asarray(mask))
        )
        assert acts.dtype == np.int32 and acts.shape == (64,)
        has = mask.any(axis=1)
        assert mask[np.arange(64)[has], acts[has]].all()
        assert (acts[~has] == 0).all()
        assert acts[1] == 39


def test_integer_rule_is_uniform_over_the_effective_set():
    mask = np.zeros((1, 30), bool)
    mask[0, [3, 7, 8, 20, 29]] = True
    keys = jax.random.split(jax.random.PRNGKey(0), 4000)
    acts = np.asarray(
        jax.vmap(lambda k: chip_smoke.uniform_effective_actions(k, jnp.asarray(mask)))(keys)
    )[:, 0]
    counts = np.array([(acts == a).sum() for a in [3, 7, 8, 20, 29]])
    assert counts.sum() == 4000
    assert counts.min() > 650 and counts.max() < 950  # 800 expected each


def _tree():
    from tile_match_tpu.state import EnvState

    states = EnvState(
        colour=np.ones((3, 5, 5), np.int32),
        kind=np.ones((3, 5, 5), np.int32),
        timer=np.zeros((3,), np.int32),
        key=np.zeros((3, 2), np.uint32),
    )
    per_step = {"reward": np.zeros((4, 3), np.float32), "done": np.zeros((4, 3), bool)}
    return states, per_step


def test_comparison_passes_equal_trees():
    assert chip_smoke.first_difference(_tree(), _tree()) is None


@pytest.mark.parametrize(
    "leaf", ["colour", "kind", "timer", "key", "reward", "done"]
)
def test_comparison_flags_a_one_cell_difference(leaf):
    got = _tree()
    states, per_step = got
    arr = getattr(states, leaf) if leaf in ("colour", "kind", "timer", "key") else per_step[leaf]
    flat = arr.reshape(-1)
    flat[-1] = flat[-1] + 1 if arr.dtype != bool else ~flat[-1]
    diff = chip_smoke.first_difference(got, _tree())
    assert diff is not None and leaf in diff and "1 elements differ" in diff


def test_comparison_flags_a_dtype_difference():
    states, per_step = _tree()
    per_step["reward"] = per_step["reward"].astype(np.float64)
    diff = chip_smoke.first_difference((states, per_step), _tree())
    assert diff is not None and "float64" in diff


def test_invariants_hold_for_a_real_rollout_and_catch_a_bad_one():
    cfg = EnvConfig(5, 5, 3, 3)
    steps = cfg.num_moves + 1
    reset, scan = chip_smoke.rollout_programs(cfg, 8, steps, record=False)
    key = jax.random.PRNGKey(0)
    states, mask = reset(key)
    states, per_step = jax.device_get(scan(states, mask, key))
    assert per_step["done"].tolist() == [0, 0, 8, 0]
    chip_smoke.check_invariants(cfg, 8, steps, states, per_step)
    bad = dict(per_step, done=np.array([0, 0, 7, 0]))
    with pytest.raises(AssertionError, match="done counts"):
        chip_smoke.check_invariants(cfg, 8, steps, states, bad)
    with pytest.raises(AssertionError, match="timers"):
        chip_smoke.check_invariants(cfg, 8, steps, states.replace(timer=states.timer * 0), per_step)


def test_cpu_reference_writer_round_trips(tmp_path):
    path = str(tmp_path / "config0.npz")
    chip_smoke.write_cpu_reference(0, path)
    cfg = CONFIGS[0]
    want = chip_smoke.run_recorded(cfg, cfg.num_moves + 1)
    with np.load(path) as z:
        leaves = [z[f"arr_{j}"] for j in range(len(z.files))]
    got = jax.tree.unflatten(jax.tree.structure(want), leaves)
    assert chip_smoke.first_difference(got, want) is None
    rewards = want[1]["reward"]
    assert rewards.shape == (cfg.num_moves + 1, chip_smoke.CHECK_BATCH)
    assert want[1]["effective_actions"].shape[-1] == cfg.num_actions


def test_golden_replay_on_the_cpu(tmp_path):
    assert chip_smoke.replay_golden() == 21
    with open(chip_smoke.GOLDEN) as f:
        episodes = json.load(f)
    episodes[1]["steps"][2]["reward"] += 1
    bad = tmp_path / "golden.json"
    bad.write_text(json.dumps(episodes))
    with pytest.raises(AssertionError, match="episode 1 step 3: reward"):
        chip_smoke.replay_golden(str(bad))
