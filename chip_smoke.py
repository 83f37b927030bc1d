#!/usr/bin/env python3
"""Smoke test of the batched env step on NVIDIA GPUs.

    python chip_smoke.py               # one GPU: phases 1-4
    python chip_smoke.py --four-cards  # four GPUs: phase 5 only

1. Device: refuse any platform but ``gpu``; print the card's name and power
   limit (``nvidia-smi``), the JAX version and the device kind.
2. Main path at full size: for each ``BASELINE.json`` config at its batch,
   jit ``batched_reset`` and a ``lax.scan`` of ``batched_step`` with the
   uniform random-effective policy for ``num_moves + 1`` steps, so every
   board auto-resets once.  Prints compile seconds, steps/s of the scan and
   peak device memory, and checks the outputs' invariants.
3. GPU against CPU: the same two programs at b256 on the GPU and, in
   ``JAX_PLATFORMS=cpu`` child processes started before phase 2, on the
   CPU backend; every final ``EnvState`` leaf and every per-step reward, done,
   cascade trip count, truncation flag, action and effective-action mask
   must be equal.  The step is an integer program, so equality is exact.
4. Golden episodes: replay ``tests/golden_episodes.json`` through
   ``ParityEngine`` (its jitted kernels on the GPU) and require the
   recorded boards, rewards, dones, infos and effective-action lists.
5. Four cards: ``sharded_rollout`` of the flagship config on a ``dp=4`` mesh
   at 4x4096 boards against ``dp=1`` on one card at the same global batch;
   per-board rewards and every final ``EnvState`` leaf must be equal.

Any failure exits non-zero.  The last line printed is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(_ROOT, "tests", "golden_episodes.json")
CHECK_BATCH = 256
FLAGSHIP = 3
FOUR_CARD_BATCH = 4 * 4096
CPU_REFERENCE_TIMEOUT_S = 900


def require_gpu():
    """The JAX devices, if the first is a GPU; otherwise exit non-zero."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found {devices[0].platform!r}"
        )
    return devices


def nvidia_smi_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return [line for line in out.stdout.splitlines() if line.strip()]


def uniform_effective_actions(key, mask):
    """One action per board, uniform over its effective actions.

    Integer arithmetic only (``randint`` and a rank among the set bits), so
    every backend picks the same actions from the same key and mask.  A
    board with no effective action gets action 0.
    """
    import jax
    import jax.numpy as jnp

    n_eff = mask.sum(axis=-1, dtype=jnp.int32)
    pick = jax.random.randint(key, n_eff.shape, 0, jnp.maximum(n_eff, 1))
    rank = jnp.cumsum(mask, axis=-1, dtype=jnp.int32) - 1
    hit = mask & (rank == pick[..., None])
    return jnp.where(n_eff > 0, jnp.argmax(hit, axis=-1), 0).astype(jnp.int32)


def rollout_programs(cfg, batch: int, steps: int, record: bool):
    """(reset, scan): ``reset(key) -> (states, mask)`` and
    ``scan(states, mask, key) -> (states, per_step)``.

    With ``record`` the per-step outputs are the full [steps, batch, ...]
    rewards, dones, cascade trips, truncation flags, actions and masks;
    without it they are per-step totals, so memory is the step's own.
    """
    import jax
    import jax.numpy as jnp

    from tile_match_tpu.envs.batched import batched_reset, batched_step

    def reset(key):
        states, ts = batched_reset(cfg, key, batch)
        return states, ts.info.effective_actions

    def scan(states, mask, key):
        def body(carry, _):
            states, mask, key = carry
            key, ka = jax.random.split(key)
            actions = uniform_effective_actions(ka, mask)
            states, ts = batched_step(cfg, states, actions, eff_mask=mask)
            info = ts.info
            if record:
                out = {
                    "reward": ts.reward,
                    "done": ts.done,
                    "cascade_trips": info.cascade_trips,
                    "truncated": info.truncated,
                    "action": actions,
                    "effective_actions": info.effective_actions,
                }
            else:
                out = {
                    "reward": ts.reward.sum(),
                    "done": ts.done.sum(dtype=jnp.int32),
                    "cascade_trips": info.cascade_trips.max(),
                    "truncated": info.truncated.sum(dtype=jnp.int32),
                }
            return (states, info.effective_actions, key), out

        (states, mask, _), per_step = jax.lax.scan(
            body, (states, mask, key), None, length=steps
        )
        return states, per_step

    return jax.jit(reset), jax.jit(scan)


def first_difference(got, want) -> str | None:
    """None if the two pytrees are equal leaf for leaf, else where they differ."""
    import jax

    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    if len(got_leaves) != len(want_leaves):
        return f"{len(got_leaves)} leaves against {len(want_leaves)}"
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        name = jax.tree_util.keystr(path)
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape or a.dtype != b.dtype:
            return f"{name}: {a.dtype}{a.shape} against {b.dtype}{b.shape}"
        if not np.array_equal(a, b):
            idx = tuple(int(i) for i in np.argwhere(a != b)[0])
            n = int((a != b).sum())
            return f"{name}: {n} elements differ, first at {idx}: {a[idx]} != {b[idx]}"
    return None


def check_invariants(cfg, batch: int, steps: int, states, per_step) -> None:
    """What a correct auto-resetting rollout of ``steps`` steps must show."""
    dones = np.asarray(per_step["done"])
    want = np.zeros(steps, np.int64)
    want[cfg.num_moves - 1 :: cfg.num_moves] = batch
    if not np.array_equal(dones, want):
        raise AssertionError(f"done counts per step {dones.tolist()}")
    timer = np.asarray(states.timer)
    if not np.all(timer == steps % cfg.num_moves):
        raise AssertionError(f"timers after the rollout: {np.unique(timer)}")
    reward = np.asarray(per_step["reward"])
    if not (np.all(np.isfinite(reward)) and np.all(reward >= 0)):
        raise AssertionError("rewards not finite and non-negative")
    colour, kind = np.asarray(states.colour), np.asarray(states.kind)
    if colour.min() < 0 or colour.max() > cfg.num_colours:
        raise AssertionError("colour out of range")
    if kind.min() < -1 or kind.max() > 4 or (kind == 0).any():
        raise AssertionError("kind out of range, or an empty cell left")


def phase_main_path(device) -> None:
    import jax

    from tile_match_tpu.baseline_configs import BATCHES, CONFIGS, spec_label

    for i, (cfg, batch) in enumerate(zip(CONFIGS, BATCHES)):
        steps = cfg.num_moves + 1
        reset, scan = rollout_programs(cfg, batch, steps, record=False)
        key = jax.random.PRNGKey(i)
        t0 = time.perf_counter()
        reset_c = reset.lower(key).compile()
        states, mask = jax.block_until_ready(reset_c(key))
        scan_c = scan.lower(states, mask, key).compile()
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        states, per_step = jax.block_until_ready(scan_c(states, mask, key))
        run_s = time.perf_counter() - t0
        check_invariants(cfg, batch, steps, states, per_step)
        mem = scan_c.memory_analysis()
        peak = device.memory_stats()["peak_bytes_in_use"]
        print(
            f"main path: config {i} {cfg.num_rows}x{cfg.num_cols}x"
            f"{cfg.num_colours} {spec_label(cfg)} batch={batch} steps={steps} "
            f"compile_s={compile_s:.1f} run_s={run_s:.3f} "
            f"steps_per_s={batch * steps / run_s:.1f} "
            f"scan_temp_bytes={mem.temp_size_in_bytes} "
            f"process_peak_bytes={peak} "
            f"max_trips={int(np.max(per_step['cascade_trips']))} "
            f"truncated={int(np.sum(per_step['truncated']))}",
            flush=True,
        )
        del states, mask, per_step, reset_c, scan_c


def run_recorded(cfg, steps: int):
    """The b256 recorded rollout of ``cfg`` on the default device, on the host."""
    import jax

    reset, scan = rollout_programs(cfg, CHECK_BATCH, steps, record=True)
    key = jax.random.PRNGKey(100)
    states, mask = reset(key)
    return jax.device_get(scan(states, mask, key))


def start_cpu_references(tmpdir: str) -> list:
    """One ``JAX_PLATFORMS=cpu`` child per config computing its recorded
    rollout into ``tmpdir``.  The children never open a GPU, and they run
    while the GPU works through phase 2.  Each child's output goes to
    ``config<i>.log`` in ``tmpdir``."""
    from tile_match_tpu.baseline_configs import CONFIGS

    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    children = []
    for i in range(len(CONFIGS)):
        with open(os.path.join(tmpdir, f"config{i}.log"), "w") as log:
            children.append(
                subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--cpu-reference", str(i),
                     os.path.join(tmpdir, f"config{i}.npz")],
                    env=env, stdout=log, stderr=subprocess.STDOUT,
                )
            )
    return children


def write_cpu_reference(index: int, path: str) -> None:
    """Child side of ``start_cpu_references``."""
    import jax

    from tile_match_tpu.baseline_configs import CONFIGS

    if jax.devices()[0].platform != "cpu":
        raise SystemExit("chip_smoke: the CPU reference must run on the CPU")
    cfg = CONFIGS[index]
    leaves = jax.tree.leaves(run_recorded(cfg, cfg.num_moves + 1))
    np.savez(path, *leaves)


def phase_gpu_vs_cpu(children: list, tmpdir: str) -> None:
    import jax

    from tile_match_tpu.baseline_configs import CONFIGS

    for i, cfg in enumerate(CONFIGS):
        steps = cfg.num_moves + 1
        gpu_out = run_recorded(cfg, steps)
        t0 = time.perf_counter()
        if children[i].wait(timeout=CPU_REFERENCE_TIMEOUT_S) != 0:
            with open(os.path.join(tmpdir, f"config{i}.log")) as log:
                tail = log.read()[-4000:]
            raise AssertionError(f"config {i}: the CPU reference failed:\n{tail}")
        wait_s = time.perf_counter() - t0
        with np.load(os.path.join(tmpdir, f"config{i}.npz")) as z:
            cpu_leaves = [z[f"arr_{j}"] for j in range(len(z.files))]
        treedef = jax.tree.structure(gpu_out)
        if treedef.num_leaves != len(cpu_leaves):
            raise AssertionError(f"config {i}: CPU reference has {len(cpu_leaves)} leaves")
        cpu_out = jax.tree.unflatten(treedef, cpu_leaves)
        diff = first_difference(gpu_out, cpu_out)
        if diff is not None:
            raise AssertionError(f"config {i}: GPU and CPU differ: {diff}")
        print(
            f"gpu == cpu: config {i} batch={CHECK_BATCH} steps={steps} "
            f"leaves={treedef.num_leaves} bit-equal "
            f"(waited {wait_s:.1f}s for the CPU)",
            flush=True,
        )


def replay_golden(path: str = GOLDEN) -> int:
    """Replay the recorded episodes through ``ParityEngine``; returns steps."""
    from tile_match_tpu.config import EnvConfig
    from tile_match_tpu.parity import ParityEngine
    from tile_match_tpu.state import action_table

    with open(path) as f:
        episodes = json.load(f)
    n_steps = 0
    for ep_i, ep in enumerate(episodes):
        R, C, K, M, seed = ep["config"]
        cfg = EnvConfig.create(
            R, C, K, M, ["cookie"], ["bomb", "vertical_laser", "horizontal_laser"]
        )
        eng = ParityEngine(cfg, np.random.default_rng(seed))
        c1, c2 = action_table(cfg)
        eng.generate_board()

        def fail(what, t):
            raise AssertionError(f"golden episode {ep_i} step {t}: {what} differs")

        if not np.array_equal(eng.board, np.asarray(ep["reset_board"])):
            fail("reset board", -1)
        if np.flatnonzero(eng.effective_mask()).tolist() != ep["reset_effective"]:
            fail("reset effective actions", -1)
        for t, rec in enumerate(ep["steps"], start=1):
            a = rec["action"]
            stats = eng.move(tuple(c1[a]), tuple(c2[a]))
            done = t == M
            effective = [] if done else np.flatnonzero(eng.effective_mask()).tolist()
            info = {
                "is_combination_match": bool(stats[1]),
                "num_new_specials": int(stats[2]),
                "num_specials_activated": int(stats[3]),
                "shuffled": bool(stats[4]),
                "effective_actions": effective,
            }
            if int(stats[0]) != rec["reward"]:
                fail("reward", t)
            if done != rec["done"]:
                fail("done", t)
            if not np.array_equal(eng.board, np.asarray(rec["board"])):
                fail("board", t)
            if info != rec["info"]:
                fail("info", t)
            n_steps += 1
        print(
            f"golden: episode {ep_i} {R}x{C}x{K} seed={seed} "
            f"{len(ep['steps'])} steps replayed exactly",
            flush=True,
        )
    return n_steps


def phase_four_cards(devices) -> None:
    import jax

    from tile_match_tpu.baseline_configs import CONFIGS
    from tile_match_tpu.parallel.sharding import make_mesh, sharded_rollout

    if len(devices) < 4:
        raise SystemExit(f"chip_smoke: --four-cards needs 4 GPUs, found {len(devices)}")
    cfg = CONFIGS[FLAGSHIP]
    steps = cfg.num_moves + 1
    key = jax.random.PRNGKey(7)
    results = {}
    for dp in (4, 1):
        mesh = make_mesh(devices[:dp], dp=dp, tp=1)
        fn = sharded_rollout(cfg, mesh, global_batch=FOUR_CARD_BATCH, num_steps=steps)
        t0 = time.perf_counter()
        compiled = fn.lower(key).compile()
        compile_s = time.perf_counter() - t0
        results[dp] = jax.device_get(compiled(key)[:2])
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(key))
        run_s = time.perf_counter() - t0
        sps = FOUR_CARD_BATCH * steps / run_s
        print(
            f"four cards: dp={dp} global_batch={FOUR_CARD_BATCH} steps={steps} "
            f"compile_s={compile_s:.1f} run_s={run_s:.3f} "
            f"steps_per_s={sps:.1f} steps_per_s_per_card={sps / dp:.1f}",
            flush=True,
        )
        del compiled
    diff = first_difference(results[4], results[1])
    if diff is not None:
        raise AssertionError(f"dp=4 and dp=1 differ: {diff}")
    print(
        f"four cards: dp=4 == dp=1 board for board "
        f"({FOUR_CARD_BATCH} boards, rewards and every EnvState leaf)",
        flush=True,
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the dp=4 against dp=1 phase, on four GPUs",
    )
    ap.add_argument(
        "--cpu-reference", nargs=2, metavar=("CONFIG", "PATH"),
        help="(used by phase 3) write CONFIG's b256 rollout on the CPU to PATH",
    )
    args = ap.parse_args(argv)
    sys.path.insert(0, _ROOT)
    if args.cpu_reference:
        write_cpu_reference(int(args.cpu_reference[0]), args.cpu_reference[1])
        return

    import jax

    devices = require_gpu()
    for line in nvidia_smi_lines():
        print(f"nvidia-smi: {line}", flush=True)
    print(
        f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}",
        flush=True,
    )

    from tile_match_tpu.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    if args.four_cards:
        phase_four_cards(devices)
    else:
        with tempfile.TemporaryDirectory() as tmpdir:
            children = start_cpu_references(tmpdir)
            try:
                phase_main_path(devices[0])
                phase_gpu_vs_cpu(children, tmpdir)
            finally:
                for child in children:
                    child.kill()
                    child.wait()
        replay_golden()
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": devices[0].platform,
                    "kind": devices[0].device_kind,
                    "count": len(devices),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
