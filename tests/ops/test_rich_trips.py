"""Differential stress tests on painted match shapes: XLA resolve vs C++.

Each case paints the shape it names (T/L crosses, extension lines through a
primary, cookie lines and stars, tripods, disjoint pairs) onto a line-free
checkerboard base, with and without specials on the board, for the full,
lasers+bomb and no-bomb configs, plus dense random fuzz where every shape
arises organically.  Every cascade trip is run twice: through the jitted
XLA pipeline (``get_colour_lines`` -> ``process_colour_lines`` ->
``resolve_colour_matches``, then ``gravity`` and ``apply_refill``) and
through the C++ engine's ``tmt_resolve_once``/``tmt_gravity``/
``tmt_apply_refill``; boards and activation/creation counts must agree bit
for bit after each stage.  The painted shape is the FIRST trip; later trips
run on refilled boards drawn from a seeded numpy stream.
"""

import functools

import numpy as np
import pytest

import jax

from tile_match_tpu.config import EnvConfig
from tile_match_tpu.native import _flags, load
from tile_match_tpu.ops.board_ops import apply_refill, gravity
from tile_match_tpu.ops.classify import process_colour_lines
from tile_match_tpu.ops.lines import get_colour_lines
from tile_match_tpu.ops.resolve import resolve_colour_matches

CFG_FULL = EnvConfig.create(
    8, 8, 4, 6,
    colourless_specials=("cookie",),
    colour_specials=("vertical_laser", "horizontal_laser", "bomb"),
)
CFG_LB = EnvConfig.create(
    8, 8, 4, 6,
    colourless_specials=(),
    colour_specials=("vertical_laser", "horizontal_laser", "bomb"),
)
CFG_NOBOMB = EnvConfig.create(
    8, 8, 4, 6,
    colourless_specials=("cookie",),
    colour_specials=("vertical_laser", "horizontal_laser"),
)


@functools.lru_cache(maxsize=None)
def _xla_trip(cfg):
    """One cascade trip through the XLA pipeline: (resolved colour, kind,
    activated, created, overflow) and the board after gravity + refill."""

    def trip(colour, kind, grid):
        ls = get_colour_lines(cfg, colour, kind)
        m = process_colour_lines(cfg, colour, ls)
        colour, kind, act, new, ovf = resolve_colour_matches(cfg, colour, kind, m)
        fc, fk = apply_refill(*gravity(colour, kind), grid)
        return colour, kind, act, new, m.ovf | ovf, fc, fk

    return jax.jit(trip)


def cpp_trip(lib, cfg, colour, kind, grid):
    """The same trip through the C++ engine, on copies of the board."""
    R, C = cfg.num_rows, cfg.num_cols
    colour, kind = colour.copy(), kind.copy()
    stats = np.zeros((2,), np.int32)
    had = lib.tmt_resolve_once(colour, kind, R, C, _flags(cfg), stats)
    resolved = colour.copy(), kind.copy()
    lib.tmt_gravity(colour, kind, R, C)
    lib.tmt_apply_refill(colour, kind, np.ascontiguousarray(grid), R, C)
    return bool(had), resolved, stats, (colour, kind)


def assert_cascade_match(cfg, colour_b, kind_b, seed, tag):
    """Run every board's cascade trip by trip through both engines."""
    lib = load()
    trip = _xla_trip(cfg)
    rng = np.random.default_rng(seed)
    R, C, K = cfg.num_rows, cfg.num_cols, cfg.num_colours
    for b in range(colour_b.shape[0]):
        colour = np.ascontiguousarray(colour_b[b], np.int32)
        kind = np.ascontiguousarray(kind_b[b], np.int32)
        for t in range(cfg.max_cascades):
            grid = rng.integers(1, K + 1, size=(R, C)).astype(np.int32)
            had, (rc, rk), stats, (fc, fk) = cpp_trip(lib, cfg, colour, kind, grid)
            jc, jk, act, new, ovf, jfc, jfk = jax.device_get(
                trip(colour, kind, grid)
            )
            where = f"{tag}: board {b} trip {t}\ncolour:\n{colour}\nkind:\n{kind}"
            assert not ovf, f"{where}\ncapacity overflow"
            if not had:
                assert int(act) == 0 and int(new) == 0, where
                assert np.array_equal(jc, colour) and np.array_equal(jk, kind), where
                break
            assert np.array_equal(rc, jc), f"{where}\ncpp:\n{rc}\nxla:\n{jc}"
            assert np.array_equal(rk, jk), f"{where}\ncpp:\n{rk}\nxla:\n{jk}"
            assert (int(stats[0]), int(stats[1])) == (int(act), int(new)), where
            assert np.array_equal(fc, jfc) and np.array_equal(fk, jfk), where
            colour, kind = fc, fk
        else:
            raise AssertionError(f"{tag}: board {b} still matching after the cap")


def base_board(R, C, K, rng):
    """A line-free base: tiles alternate among colours by (r + 2c) % K
    pattern with noise re-rolled until line-free."""
    # checkerboard of two colours is always line-free for K >= 2
    a, b = rng.choice(np.arange(1, K + 1), size=2, replace=False)
    col = np.where((np.add.outer(np.arange(R), np.arange(C))) % 2 == 0, a, b)
    return col.astype(np.int32)


def paint(col, shapes):
    for cells, colour in shapes:
        for (r, c) in cells:
            col[r, c] = colour
    return col


def hline(r, c0, n):
    return [(r, c0 + i) for i in range(n)]


def vline(r0, c, n):
    return [(r0 + i, c) for i in range(n)]


# ---------------------------------------------------------------------------
# Targeted shape constructions, one batch per case family.  Colour 4 is held
# out of the checkerboard bases (which only use rng-chosen pairs) often
# enough; use a colour not in the base for the painted line.
# ---------------------------------------------------------------------------


def shape_batch(cfg, shapes_fn, n_variants, seed, specials=None):
    R, C, K = cfg.num_rows, cfg.num_cols, cfg.num_colours
    rng = np.random.default_rng(seed)
    cols, kinds = [], []
    for i in range(n_variants):
        col = base_board(R, C, K, rng)
        used = set(np.unique(col))
        free = [k for k in range(1, K + 1) if k not in used]
        paint_colour = free[rng.integers(len(free))] if free else 1
        shapes = shapes_fn(i, rng, paint_colour)
        col = paint(col, shapes)
        kind = np.ones((R, C), np.int32)
        if specials:
            for _ in range(specials):
                r, c = rng.integers(0, R), rng.integers(0, C)
                sk = int(rng.choice([2, 3, 4, -1]))
                kind[r, c] = sk
                if sk == -1:
                    col[r, c] = 0
        cols.append(col)
        kinds.append(kind)
    return np.stack(cols), np.stack(kinds)


CASES = {
    # h x v crossing primaries, both len 3 (T and L variants)
    "cross33": lambda i, rng, pc: [
        (hline(5, 1 + (i % 3), 3), pc),
        (vline(3, 1 + (i % 3) + (i % 3 == 0), 3), pc),
    ],
    # crossing with the h-line len 4
    "cross43": lambda i, rng, pc: [
        (hline(5, 1, 4), pc),
        (vline(3, 1 + (i % 4), 3), pc),
    ],
    # crossing with the v-line len 4 (h len 3 or 4)
    "crossv4": lambda i, rng, pc: [
        (hline(6, 2, 3 + (i % 2)), pc),
        (vline(3, 2 + (i % 3), 4), pc),
    ],
    # v-primary + h-extension through it (ext lens 3 and 4, various rows)
    "ghost_ext_h": lambda i, rng, pc: [
        (vline(3, 4, 3), pc),
        (hline(3 + (i % 3), 4 - 1 - (i % 2), 3 + (i // 3) % 2), pc),
    ],
    # h-primary + v-extension (uext 0/1/2, ext lens 3 and 4)
    "ghost_ext_v": lambda i, rng, pc: [
        (hline(4, 2, 3), pc),
        (vline(4 - (i % 3), 2 + (i % 3), 3 + (i // 3) % 2), pc),
    ],
    # h-primary len 4 + v-extension
    "ghost_ext_v4": lambda i, rng, pc: [
        (hline(4, 2, 4), pc),
        (vline(4 - (i % 3), 2 + (i % 4), 3 + (i // 4) % 2), pc),
    ],
    # unshared cookie lines, len 5..8, h and v
    "cookie_h": lambda i, rng, pc: [(hline(2 + (i % 4), 0, 5 + (i % 4)), pc)],
    "cookie_v": lambda i, rng, pc: [(vline(0, 1 + (i % 5), 5 + (i % 4)), pc)],
    # shared cookie line (must defer, still bit-exact)
    "cookie_shared": lambda i, rng, pc: [
        (hline(5, 1, 5 + (i % 3)), pc),
        (vline(2 + (i % 2), 2 + (i % 4), 3), pc),
    ],
    # two disjoint pairs + a single normal in one trip
    "multi_pair": lambda i, rng, pc: [
        (hline(6, 0, 3), pc),
        (vline(4, 1, 3), pc),
        (hline(7, 4, 3), pc),
        (vline(5, 5, 3), pc),
    ],
    # multi-share (one line sharing with two) — defers, still bit-exact
    "tripod": lambda i, rng, pc: [
        (hline(5, 1, 4 + (i % 2)), pc),
        (vline(3, 2, 3), pc),
        (vline(3, 4, 3), pc),
    ],
    # v-centre star: one v-primary with TWO h-extensions (round-5 star
    # absorption: bomb at the topmost generator, other ext independent)
    "v_star2": lambda i, rng, pc: [
        (vline(3, 4, 3 + (i % 2)), pc),
        (hline(3, 3, 3), pc),
        (hline(4 + (i % 2), 4 - (i % 2), 3 + (i // 2) % 2), pc),
    ],
    # h-centre star: one h-primary with TWO v-extensions (uext mixes drive
    # the initiator/partner pop-order cases)
    "h_star2": lambda i, rng, pc: [
        (hline(4, 1, 3 + (i % 2)), pc),
        (vline(4 - (i % 3), 1, 3 + (i // 3) % 2), pc),
        (vline(4 - ((i + 1) % 3), 3, 3 + (i // 6) % 2), pc),
    ],
    # shared cookie centres: a len-5..7 line with extension/cross leaves
    "cookie_star_v": lambda i, rng, pc: [
        (vline(1, 3, 5 + (i % 3)), pc),
        (hline(2 + (i % 4), 2 + (i % 2), 3 + (i // 4) % 2), pc),
    ],
    "cookie_star_h": lambda i, rng, pc: [
        (hline(3, 1, 5 + (i % 3)), pc),
        (vline(3, 2 + (i % 4), 3 + (i // 4) % 2), pc),  # uext == 0 ext
    ],
    "cookie_cross_v": lambda i, rng, pc: [
        (vline(1, 2, 5 + (i % 3)), pc),
        (hline(2 + (i % 4), 1, 3 + (i // 4) % 2), pc),  # crossing h-line
    ],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_painted_shapes_full_specials(case):
    cols, kinds = shape_batch(CFG_FULL, CASES[case], 12, seed=hash(case) % 1000)
    assert_cascade_match(CFG_FULL, cols, kinds, 3, f"full:{case}")


@pytest.mark.parametrize("case", ["cross33", "cross43", "crossv4",
                                  "ghost_ext_h", "ghost_ext_v", "cookie_h"])
def test_painted_shapes_with_specials_on_board(case):
    cols, kinds = shape_batch(
        CFG_FULL, CASES[case], 12, seed=hash(case) % 997, specials=3
    )
    assert_cascade_match(CFG_FULL, cols, kinds, 5, f"sp:{case}")


@pytest.mark.parametrize("case", ["cross33", "cross43", "ghost_ext_v",
                                  "cookie_h", "tripod"])
def test_painted_shapes_lasers_bomb_only(case):
    cols, kinds = shape_batch(CFG_LB, CASES[case], 10, seed=hash(case) % 991)
    assert_cascade_match(CFG_LB, cols, kinds, 7, f"lb:{case}")


@pytest.mark.parametrize("case", ["cross33", "ghost_ext_h", "cookie_h",
                                  "cookie_v", "cookie_shared"])
def test_painted_shapes_no_bomb(case):
    cols, kinds = shape_batch(
        CFG_NOBOMB, CASES[case], 10, seed=hash(case) % 983
    )
    assert_cascade_match(CFG_NOBOMB, cols, kinds, 9, f"nb:{case}")


@pytest.mark.parametrize("seed", range(4))
def test_random_lined_boards_fuzz(seed):
    """Uniform random boards: every shape family arises organically, and
    trips 2+ run on refilled boards."""
    rng = np.random.default_rng(seed)
    B, R, C = 48, 8, 8
    cols = rng.integers(1, 5, size=(B, R, C)).astype(np.int32)
    kinds = np.ones((B, R, C), np.int32)
    # sprinkle specials on half the boards
    for b in range(0, B, 2):
        for _ in range(rng.integers(1, 5)):
            r, c = rng.integers(0, R), rng.integers(0, C)
            k = int(rng.choice([2, 3, 4, -1]))
            kinds[b, r, c] = k
            if k == -1:
                cols[b, r, c] = 0
    assert_cascade_match(CFG_FULL, cols, kinds, seed + 20, f"fuzz{seed}")


def test_bomb_pair_consumed_in_kernel():
    """A clean T-cross: both engines create the bomb at the share point in
    the first trip."""
    rng = np.random.default_rng(0)
    col = base_board(8, 8, 4, rng)
    used = set(np.unique(col))
    pc = [k for k in range(1, 5) if k not in used][0]
    paint(col, [(hline(5, 2, 3), pc), (vline(3, 3, 3), pc)])
    kind = np.ones((8, 8), np.int32)
    grid = np.ones((8, 8), np.int32)
    had, (_, rk), stats, _ = cpp_trip(load(), CFG_FULL, col, kind, grid)
    assert had and int(stats[1]) == 1, "the T-cross created no special"
    assert rk[5, 3] == 4, f"no bomb at the share point:\n{rk}"
    assert_cascade_match(CFG_FULL, col[None], kind[None], 3, "bomb_pair")


def test_cookie_creation_consumed_in_kernel():
    """A length-5 line: both engines create a cookie in the first trip."""
    rng = np.random.default_rng(1)
    col = base_board(8, 8, 4, rng)
    used = set(np.unique(col))
    pc = [k for k in range(1, 5) if k not in used][0]
    paint(col, [(hline(4, 1, 5), pc)])
    kind = np.ones((8, 8), np.int32)
    grid = np.ones((8, 8), np.int32)
    had, (_, rk), stats, _ = cpp_trip(load(), CFG_FULL, col, kind, grid)
    assert had and int(stats[1]) == 1, "the length-5 line created no special"
    assert (rk[4] == -1).sum() == 1, f"no cookie on the line's row:\n{rk}"
    assert_cascade_match(CFG_FULL, col[None], kind[None], 4, "cookie")


CFG_BIG = EnvConfig.create(
    15, 18, 5, 6,
    colourless_specials=("cookie",),
    colour_specials=("vertical_laser", "horizontal_laser", "bomb"),
)


@pytest.mark.parametrize("seed", [0, 1])
def test_big_board_lean_path(seed):
    """A 15x18 board (R*C > 256, non-square) with random colours and
    specials: bit-exact against the C++ engine."""
    rng = np.random.default_rng(seed)
    B, R, C = 12, 15, 18
    cols = rng.integers(1, 6, size=(B, R, C)).astype(np.int32)
    kinds = np.ones((B, R, C), np.int32)
    for b in range(0, B, 2):
        for _ in range(rng.integers(1, 6)):
            r, c = rng.integers(0, R), rng.integers(0, C)
            k = int(rng.choice([2, 3, 4, -1]))
            kinds[b, r, c] = k
            if k == -1:
                cols[b, r, c] = 0
    assert_cascade_match(CFG_BIG, cols, kinds, seed + 60, f"big{seed}")
