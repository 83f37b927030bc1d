"""Benchmark: batched env-steps/s on one GPU.

Protocol: one jitted program scans CHUNK full env steps for the whole batch
(the framework's device-side rollout path — `envs.batched.rollout`), called
in a host loop with async dispatch and no host transfers, and timed to
`block_until_ready`.  Every scanned step does the complete per-step work:
masked random-effective policy, effective-action mask, swap, combination
branch, cascades with specials, gravity/refill, playability shuffles,
auto-reset.

Configs: the five rows of `BASELINE.json:6-12`; select with `--config N`
(0-4) or env `TMT_BENCH_CONFIG`.  Default is config 3 (10x10, 4 colours,
full specials — the README flagship).

Device: the bench needs a GPU and exits non-zero without one.  With
`JAX_PLATFORMS=cpu` set explicitly it runs on the CPU at a tiny batch
instead; that number is a CPU number, not a device measurement.  XLA
programs are kept in the persistent compile cache
(`tile_match_tpu.compile_cache`).

Baseline: the reference env stepped on CPU.  numba is not installed in this
image, so the reference runs de-jitted (no-op njit shim) and the baseline
is CALIBRATED from measurements (see get_baseline): the per-step time spent
in the njit'able `is_move_effective` sweep is measured directly, its numba
speedup is bounded by this repo's C++ engine running the same windowed
test, and only that portion of the step is accelerated (Amdahl) — the rest
of the reference's step is pure Python that numba never touches.  The
legacy guessed whole-step NJIT_FACTOR=30 remains only as a fallback when
the C++ toolchain is absent.  Cached in bench_baseline.json per config with
the measured components.

Prints exactly one JSON line:
  {"metric": ..., "value": N, "unit": "steps/s", "vs_baseline": N}
"""

from __future__ import annotations

import json
import os
import sys
import time

from tile_match_tpu.baseline_configs import BATCHES, CONFIGS, spec_label

NJIT_FACTOR = 30.0
_DIR = os.path.dirname(os.path.abspath(__file__))
BASELINE_CACHE = os.path.join(_DIR, "bench_baseline.json")


def _config_index() -> int:
    if "--config" in sys.argv:
        idx = sys.argv.index("--config")
        if idx + 1 >= len(sys.argv):
            sys.exit("bench.py: --config requires an integer argument 0-4")
        try:
            n = int(sys.argv[idx + 1])
        except ValueError:
            sys.exit(f"bench.py: --config must be an integer, got {sys.argv[idx + 1]!r}")
    else:
        n = int(os.environ.get("TMT_BENCH_CONFIG", "3"))
    if not 0 <= n < len(CONFIGS):
        sys.exit(f"bench.py: config index {n} out of range 0-{len(CONFIGS) - 1}")
    return n


CFG_IDX = _config_index()
CFG = CONFIGS[CFG_IDX]
R, C, K, MOVES = CFG.num_rows, CFG.num_cols, CFG.num_colours, CFG.num_moves
COLOURLESS, COLOUR_SP = CFG.colourless_specials, CFG.colour_specials

# Steps per dispatch; like the batch sizes, not yet tuned on the GPU.
CHUNK = 8
REPS = int(os.environ.get("TMT_BENCH_REPS", "3"))


BASELINE_METHOD = "calibrated-v5"


def measure_reference_cpu(budget_s: float = 5.0):
    """Reference env on CPU (de-jitted), random effective actions.

    Returns (steps_per_s, sweep_seconds_per_step, sweep_calls_per_step):
    the module-level ``is_move_effective`` — the reference's ONLY njit hot
    function of consequence (`board.py:735-787`, called O(actions) per step)
    — is wrapped with a perf counter in both modules that bind it, so the
    per-step time attributable to the njit'able sweep is measured, not
    guessed.  (Wrapper overhead ~0.2us/call vs ~5-15us/call measured work:
    <3% and it biases the calibrated factor conservatively downward.)
    """
    import types

    import numpy as np

    if "numba" not in sys.modules:
        numba = types.ModuleType("numba")

        def njit(f=None, **kw):
            return f if callable(f) else (lambda g: g)

        class _Any:
            def __getattr__(self, name):
                return lambda *a, **k: None

        numba.njit = njit
        numba.types = _Any()
        numba.typeof = lambda x: None
        sys.modules["numba"] = numba
    ref_path = "/root/reference/src"
    if os.path.isdir(ref_path) and ref_path not in sys.path:
        sys.path.insert(0, ref_path)
    try:
        import tile_match_gym.board as refboard
        import tile_match_gym.tile_match_env as refenvmod
        from tile_match_gym.tile_match_env import TileMatchEnv
    except Exception:
        return 0.0, 0.0, 0.0

    sweep = {"n": 0, "t": 0.0}
    orig = refboard.is_move_effective

    def timed(*a, **kw):
        t0 = time.perf_counter()
        r = orig(*a, **kw)
        sweep["t"] += time.perf_counter() - t0
        sweep["n"] += 1
        return r

    refboard.is_move_effective = timed
    if getattr(refenvmod, "is_move_effective", None) is orig:
        refenvmod.is_move_effective = timed
    try:
        env = TileMatchEnv(
            R, C, K, MOVES, list(COLOURLESS), list(COLOUR_SP), seed=0
        )
        rng = np.random.default_rng(0)
        obs, info = env.reset()
        sweep["n"] = 0
        sweep["t"] = 0.0
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < budget_s:
            eff = info["effective_actions"]
            a = (
                int(rng.choice(eff))
                if eff
                else int(rng.integers(env.num_actions))
            )
            obs, r, done, _, info = env.step(a)
            n += 1
            if done:
                obs, info = env.reset()
        dt = time.perf_counter() - t0
    finally:
        refboard.is_move_effective = orig
        if getattr(refenvmod, "is_move_effective", None) is timed:
            refenvmod.is_move_effective = orig
    return n / dt, sweep["t"] / max(n, 1), sweep["n"] / max(n, 1)


def measure_cpp_sweep_percall(budget_s: float = 2.0) -> float:
    """Seconds per single windowed effective test in this repo's C++ engine
    (`csrc/tmt_engine.cpp` move_effective via tmt_effective_mask) — an upper
    bound on what numba could make the reference's `is_move_effective`
    (same algorithm, same window) run at."""
    import numpy as np

    from tile_match_tpu.config import EnvConfig
    from tile_match_tpu.native import NativeEngine

    cfg = EnvConfig.create(
        R, C, K, MOVES, colourless_specials=COLOURLESS,
        colour_specials=COLOUR_SP,
    )
    eng = NativeEngine(cfg, seed=1)
    eng.generate_board()
    A = cfg.num_actions
    # warm
    eng.effective_mask()
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < budget_s:
        eng.effective_mask()
        n += 1
    dt = time.perf_counter() - t0
    return dt / (n * A)


def get_baseline() -> float:
    """The numba-reference stand-in rate, CALIBRATED (VERDICT r4 item 4).

    numba cannot be installed here, so the baseline is built from
    measurements instead of the legacy guessed 30x factor:

      t_step      de-jitted reference seconds/step (measured)
      T_sweep     of which, seconds/step inside `is_move_effective` (measured)
      f_sweep     de-jitted-vs-C++ per-call ratio for that exact windowed
                  test (measured; C++ >= numba, so this over-corrects in the
                  baseline's FAVOUR)
      baseline    1 / (t_step - T_sweep + T_sweep / f_sweep)   [Amdahl]

    i.e. only the portion of the step numba would actually compile gets the
    speedup.  Falls back to the legacy conservative 30x whole-step factor if
    the C++ engine is unavailable.
    """
    cache = {}
    if os.path.exists(BASELINE_CACHE):
        with open(BASELINE_CACHE) as f:
            cache = json.load(f)
        # legacy single-config layout → keep as config-3 entry
        if "baseline_steps_per_s" in cache and cache.get("config") == [10, 10, 4]:
            cache = {"3": cache}
    key = str(CFG_IDX)
    if (
        key in cache
        and "baseline_steps_per_s" in cache[key]
        and cache[key].get("method") == BASELINE_METHOD
    ):
        return cache[key]["baseline_steps_per_s"]
    raw, sweep_s, sweep_calls = measure_reference_cpu()
    entry = {
        "config": [R, C, K],
        "reference_dejitted_steps_per_s": raw,
        "sweep_seconds_per_step": sweep_s,
        "sweep_calls_per_step": sweep_calls,
    }
    t_step = 1.0 / raw if raw > 0 else 0.0
    try:
        cpp_percall = measure_cpp_sweep_percall()
        dejit_percall = sweep_s / max(sweep_calls, 1e-9)
        f_sweep = max(dejit_percall / max(cpp_percall, 1e-12), 1.0)
        njit_step = t_step - sweep_s + sweep_s / f_sweep
        baseline = max(1.0 / njit_step, 1.0) if njit_step > 0 else 1.0
        entry.update(
            {
                "method": BASELINE_METHOD,
                "cpp_sweep_seconds_per_call": cpp_percall,
                "dejitted_sweep_seconds_per_call": dejit_percall,
                "measured_sweep_factor": f_sweep,
                "baseline_steps_per_s": baseline,
            }
        )
    except Exception as e:  # no C++ toolchain → legacy conservative factor
        baseline = max(raw * NJIT_FACTOR, 1.0)
        entry.update(
            {
                "method": BASELINE_METHOD,
                "fallback": f"legacy njit_factor={NJIT_FACTOR}: {e!r}"[:300],
                "njit_factor": NJIT_FACTOR,
                "baseline_steps_per_s": baseline,
            }
        )
    cache[key] = entry
    with open(BASELINE_CACHE, "w") as f:
        json.dump(cache, f)
    return baseline


def require_gpu() -> bool:
    """True on a GPU; False on the CPU when ``JAX_PLATFORMS=cpu`` asks for
    it; otherwise exit non-zero."""
    import jax

    platform = jax.devices()[0].platform
    if platform == "gpu":
        return False
    if platform == "cpu" and os.environ.get("JAX_PLATFORMS") == "cpu":
        return True
    sys.exit(
        f"bench.py: no GPU found (JAX's device is {platform!r}); "
        "set JAX_PLATFORMS=cpu to run on the CPU"
    )


def measure_ours(batch: int, chunk: int, steps: int, reps: int) -> float:
    import jax
    import jax.numpy as jnp

    from tile_match_tpu.compile_cache import enable_compile_cache
    from tile_match_tpu.envs.batched import batched_reset, batched_step

    enable_compile_cache()
    cfg = CFG

    # One dispatch = `chunk` full env steps scanned on device (the product
    # rollout path): dispatch overhead amortises while every step still does
    # the complete work — policy from the effective mask, swap, cascades,
    # specials, shuffles, auto-reset, and the next bool[A] mask.
    @jax.jit
    def run_chunk(states, mask, key):
        def body(carry, _):
            states, mask, key = carry
            key, ka = jax.random.split(key)
            logits = jnp.where(mask, 0.0, -jnp.inf)
            acts = jnp.where(
                mask.any(-1), jax.random.categorical(ka, logits, axis=-1), 0
            ).astype(jnp.int32)
            states, ts = batched_step(cfg, states, acts, eff_mask=mask)
            return (states, ts.info.effective_actions, key), ts.reward.sum()

        (states, mask, key), rs = jax.lax.scan(
            body, (states, mask, key), None, length=chunk
        )
        return states, mask, rs.sum(), key

    states, ts = jax.jit(lambda k: batched_reset(cfg, k, batch))(
        jax.random.PRNGKey(0)
    )
    mask = ts.info.effective_actions
    key = jax.random.PRNGKey(1)
    # compile + one warm chunk
    out = jax.block_until_ready(run_chunk(states, mask, key))

    best = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(steps):
            out = run_chunk(*out[:2], out[3])
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        best = max(best, batch * chunk * steps / dt)
    return best


def main():
    on_cpu = require_gpu()
    baseline = get_baseline()
    batch = int(
        os.environ.get("TMT_BENCH_BATCH", "128" if on_cpu else str(BATCHES[CFG_IDX]))
    )
    chunk = int(os.environ.get("TMT_BENCH_CHUNK", "4" if on_cpu else str(CHUNK)))
    steps = int(os.environ.get("TMT_BENCH_STEPS", "2"))
    sps = measure_ours(batch, chunk, steps, REPS)
    print(
        json.dumps(
            {
                "metric": f"env_steps_per_sec_{R}x{C}x{K}_{spec_label(CFG)}_b{batch}",
                "value": round(sps, 1),
                "unit": "steps/s",
                "vs_baseline": round(sps / baseline, 2),
            }
        )
    )


if __name__ == "__main__":
    main()
