"""Long-running differential fuzz: ParityEngine vs reference, many configs.

Runs whole episodes with mixed effective/random actions and asserts exact
board + stats + RNG-stream equality after every move.  Any divergence is
dumped with a full repro.  Usage:

    python tools/fuzz_campaign.py --minutes 30
"""

import argparse
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from tests.oracle import get_ref_board_module  # noqa: E402
from tile_match_tpu.config import EnvConfig  # noqa: E402
from tile_match_tpu.parity import ParityEngine  # noqa: E402

CONFIGS = [
    # (R, C, K, colourless, colour_specials)
    (5, 5, 3, ["cookie"], ["vertical_laser", "horizontal_laser", "bomb"]),
    (5, 5, 2, ["cookie"], ["vertical_laser", "horizontal_laser", "bomb"]),
    (3, 3, 2, [], []),
    (4, 7, 3, ["cookie"], ["bomb"]),
    (8, 8, 3, ["cookie"], ["vertical_laser", "horizontal_laser", "bomb"]),
    (10, 10, 4, ["cookie"], ["vertical_laser", "horizontal_laser", "bomb"]),
    (6, 6, 2, [], ["vertical_laser", "horizontal_laser", "bomb"]),
    (12, 4, 3, ["cookie"], ["vertical_laser"]),
    (20, 20, 6, ["cookie"], ["vertical_laser", "horizontal_laser", "bomb"]),
]


def run_one(seed):
    mod = get_ref_board_module()
    R, C, K, colourless, colour_specials = CONFIGS[seed % len(CONFIGS)]
    ref = mod.Board(R, C, K, list(colourless), list(colour_specials),
                    np.random.default_rng(seed))
    ref.generate_board()
    cfg = EnvConfig.create(R, C, K, 10, colourless, colour_specials)
    ours = ParityEngine(cfg, np.random.default_rng(seed))
    ours.generate_board()
    assert np.array_equal(ours.board, ref.board), f"generate seed={seed}"

    picker = np.random.default_rng(seed + 1)
    n_moves = 6 if R * C > 200 else 12
    for t in range(n_moves):
        mask = ours.effective_mask()
        eff = np.nonzero(mask)[0]
        if picker.random() < 0.85 and len(eff):
            a = int(picker.choice(eff))
        else:
            a = int(picker.integers(0, cfg.num_actions))
        c1 = tuple(int(v) for v in ours._c1[a])
        c2 = tuple(int(v) for v in ours._c2[a])
        rs = ref.move(c1, c2)
        os_ = ours.move(c1, c2)
        if tuple(os_) != tuple(rs) or not np.array_equal(ours.board, ref.board):
            np.save(f"/tmp/fuzz_fail_{seed}_{t}.npy", ref.board)
            raise AssertionError(
                f"DIVERGENCE seed={seed} t={t} cfg={CONFIGS[seed % len(CONFIGS)]} "
                f"action={a} stats ours={os_} ref={rs}"
            )
        assert (
            ours.np_random.bit_generator.state == ref.np_random.bit_generator.state
        ), f"rng stream diverged seed={seed} t={t}"
    return n_moves


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--minutes", type=float, default=30)
    p.add_argument("--start-seed", type=int, default=0)
    args = p.parse_args()
    t0 = time.time()
    seed = args.start_seed
    episodes = 0
    moves = 0
    while time.time() - t0 < args.minutes * 60:
        moves += run_one(seed)
        episodes += 1
        seed += 1
        if episodes % 50 == 0:
            print(f"{episodes} episodes, {moves} moves OK "
                  f"({time.time() - t0:.0f}s)", flush=True)
    print(f"DONE: {episodes} episodes, {moves} moves, all bit-exact", flush=True)


if __name__ == "__main__":
    main()
