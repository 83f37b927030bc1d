"""The core engine: pure-functional reset/step over ``EnvState``.

Array-program restructuring of ``Board.move`` (`board.py:330-395`),
``Board.generate_board`` (`board.py:95-112`) and ``TileMatchEnv.step/reset``
(`tile_match_env.py:84-112`): every unbounded Python loop becomes a bounded
``lax.while_loop`` (cascade, regeneration, playability), every per-action
scan becomes the batched effective mask, and all randomness is counter-based
threefry per environment.  ``jax.vmap(step)`` steps thousands of boards in
lockstep; see ``parallel/`` for multi-device sharding.

For bit-exact numpy-RNG parity with the reference, the same kernels are
driven by the host orchestrator in ``parity.py`` instead of this module's
threefry draws.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .config import EnvConfig
from .state import EnvState, StepInfo, action_table
from .ops.board_ops import (
    apply_refill,
    apply_shuffle,
    draw_colour_grid,
    gravity,
    swap_cells,
)
from .ops.classify import process_colour_lines
from .ops.combination import combination_match, is_combination
from .ops.effective import effective_mask_settled
from .ops.lines import (
    first_line_info,
    get_colour_lines,
    has_any_line,
    line_union_mask,
    run_member_mask,
)
from .ops.resolve import resolve_colour_matches


def _refill_native(cfg, colour, kind, key):
    key, k = jax.random.split(key)
    grid = draw_colour_grid(k, cfg)
    colour, kind = apply_refill(colour, kind, grid)
    return colour, kind, key


def make_playable(cfg: EnvConfig, colour, kind, key, init_has_lines, init_top):
    """The regenerate/playability loop shared by ``generate_board``
    (`board.py:102-109`) and the end of ``move`` (`board.py:381-391`).

    While the board has no effective move or still has colour lines: if
    lines exist, clear them (native scheme: redraw run-member cells, see
    ``clear_lines``; parity mode replays the reference's row-reroll
    host-side in parity.py); otherwise shuffle.  Returns the board, the
    ``shuffled`` info flag, and the CURRENT effective-action mask — the loop
    condition needs the full mask anyway (`possible_move` = any of it), so it
    is carried through the loop and handed back for the caller to reuse as
    the post-move mask instead of recomputing the step's largest kernel.

    Also returns ``gave_up``: True iff the iteration cap stopped the loop
    while the board was still unplayable/matchy (feeds StepInfo.truncated).
    """
    cap = cfg.max_regen_iters

    # The loop splits into two phases with the SAME decision/key sequence as
    # the reference's single loop: while lines exist the mask value is never
    # consulted (the reroll-vs-shuffle decision reads has_lines only, and
    # the exit needs ~has_lines), so the line-clearing rerolls iterate in a
    # cheap inner loop — draw + reroll + line detect, nothing else — and the
    # effective mask / shuffle permutation (the two expensive ops; the old
    # single-loop shape computed BOTH every iteration, ~40x this cost at
    # batch 2048) run only in the rare outer shuffle loop.

    def clear_lines(colour, key, has_lines, top, tot):
        """Redraw the cells of every >=3 run until the board is line-free.

        The reference rerolls all rows above the first line
        (`board.py:120-131`) — near-full-grid rejection sampling whose
        line-free acceptance probability is ~1.5e-4 at 10x10x4: measured
        mean 88 iterations per board, with ~1% of boards exceeding a
        256-iteration cap.  The native path's generation stream is this
        engine's to define (numpy-parity mode drives the reference's exact
        scheme host-side in parity.py), so it redraws ONLY the run-member
        cells each iteration — same contract (line-free, all-normal,
        uniform colours elsewhere), ~5 iterations instead of ~88.
        """
        del top  # kept in the carry for signature stability

        def c_cond(c):
            colour, key, has_lines, tot = c
            return has_lines & (tot < cap)

        def c_body(c):
            colour, key, has_lines, tot = c
            key, k = jax.random.split(key)
            runs = run_member_mask(cfg, colour)
            colour = jnp.where(runs, draw_colour_grid(k, cfg), colour)
            has_lines = has_any_line(cfg, colour, kind)
            return colour, key, has_lines, tot + 1

        colour, key, has_lines, tot = jax.lax.while_loop(
            c_cond, c_body, (colour, key, has_lines, tot)
        )
        return colour, key, has_lines, jnp.int32(0), tot

    colour, key, has_lines, top, tot = clear_lines(
        colour, key, init_has_lines, init_top, jnp.int32(0)
    )
    mask0 = effective_mask_settled(cfg, colour, kind)

    def cond(carry):
        colour, kind, key, mask, has_lines, top, shuffled, tot = carry
        return ((~jnp.any(mask)) | has_lines) & (tot < cap)

    def body(carry):
        colour, kind, key, mask, has_lines, top, shuffled, tot = carry
        key, k = jax.random.split(key)
        perm = jax.random.permutation(k, cfg.flat_size).astype(jnp.int32)
        colour, kind = apply_shuffle(colour, kind, perm)
        has_lines, top = first_line_info(cfg, colour)
        colour, key, has_lines, top, tot = clear_lines(
            colour, key, has_lines, top, tot + 1
        )
        mask = effective_mask_settled(cfg, colour, kind)
        return colour, kind, key, mask, has_lines, top, jnp.asarray(True), tot

    colour, kind, key, mask, has_lines, _, shuffled, _ = jax.lax.while_loop(
        cond,
        body,
        (colour, kind, key, mask0, has_lines, top, jnp.asarray(False), tot),
    )
    gave_up = (~jnp.any(mask)) | has_lines  # cond still true at the cap
    # A gave_up board may still contain lines, where the settled mask is not
    # exact — and the corruption would persist for the rest of the episode
    # (each step's mask feeds the next).  Zero the mask instead: every
    # further action is a no-op, the episode runs out its timer, and the
    # sticky ``truncated`` flag (fed by gave_up) marks the whole affair.
    mask = jnp.where(gave_up, jnp.zeros_like(mask), mask)
    return colour, kind, key, shuffled, mask, gave_up


def generate_board(cfg: EnvConfig, key):
    """`board.py:95-112`: fresh all-normal board, re-rolled/shuffled until
    match-free with at least one effective move.

    Also returns the generated board's effective-action mask (a by-product of
    the playability loop).
    """
    key, k = jax.random.split(key)
    colour = draw_colour_grid(k, cfg)
    kind = jnp.ones((cfg.num_rows, cfg.num_cols), jnp.int32)
    has_lines, top = first_line_info(cfg, colour)
    colour, kind, key, _, mask, gave_up = make_playable(
        cfg, colour, kind, key, has_lines, top
    )
    return colour, kind, key, mask, gave_up


def specials_cascade_trip(cfg: EnvConfig, colour, kind, sub, it):
    """One FULL cascade trip (`board.py:369-376`): detect → classify →
    resolve → gravity → refill, the refill grid drawn from
    ``fold_in(sub, it)``.  Returns (colour, kind, elim_d, act_d, new_d,
    ovf)."""
    grid = draw_colour_grid(jax.random.fold_in(sub, it), cfg)
    ls = get_colour_lines(cfg, colour, kind)
    m = process_colour_lines(cfg, colour, ls)
    colour, kind, act_d, new_d, r_ovf = resolve_colour_matches(
        cfg, colour, kind, m
    )
    elim_d = cfg.flat_size - jnp.count_nonzero(kind).astype(jnp.int32)
    colour, kind = gravity(colour, kind)
    colour, kind = apply_refill(colour, kind, grid)
    return colour, kind, elim_d, act_d, new_d, m.ovf | r_ovf


def engine_move(cfg: EnvConfig, colour, kind, key, coord1, coord2, eff, cur_mask):
    """``Board.move`` (`board.py:330-395`) minus the legality raise (the
    action table only produces legal swaps; the Gym adapter validates).

    ``cur_mask``: the CURRENT board's effective-action mask (the caller has
    it — it decided ``eff``); returned unchanged for a no-op move.

    Returns (colour, kind, key, eliminations, is_comb, new_specials,
    activated, shuffled, post_mask, truncated, trips) — ``post_mask`` is the
    effective-action mask of the returned board (free by-product of the
    playability loop); ``truncated`` is the sticky any-capacity-cap-hit
    flag; ``trips`` is the cascade loop's iteration count.
    """
    flat = cfg.flat_size

    def no_op(args):
        colour, kind, key = args
        z = jnp.int32(0)
        return (
            colour,
            kind,
            key,
            z,
            jnp.asarray(False),
            z,
            z,
            jnp.asarray(False),
            cur_mask,
            jnp.asarray(False),
            z,
        )

    def do_move(args):
        colour, kind, key = args
        colour, kind = swap_cells(colour, kind, coord1, coord2)

        if cfg.any_special:
            comb = is_combination(kind, coord1, coord2)

            def run_comb(args):
                colour, kind, key = args
                colour, kind, act, ovf = combination_match(
                    cfg, colour, kind, coord1, coord2
                )
                elim = flat - jnp.count_nonzero(kind).astype(jnp.int32)
                colour, kind = gravity(colour, kind)
                colour, kind, key = _refill_native(cfg, colour, kind, key)
                return colour, kind, key, elim, act, ovf

            def skip_comb(args):
                colour, kind, key = args
                return (
                    colour, kind, key, jnp.int32(0), jnp.int32(0),
                    jnp.asarray(False),
                )

            colour, kind, key, elim, activated, trunc = jax.lax.cond(
                comb, run_comb, skip_comb, (colour, kind, key)
            )
        else:
            # no specials can ever exist on the board → no combinations
            comb = jnp.asarray(False)
            elim = jnp.int32(0)
            activated = jnp.int32(0)
            trunc = jnp.asarray(False)

        # cascade: detect → resolve → gravity → refill until no matches
        # (`board.py:367-376`), bounded by max_cascades.  Refill randomness
        # is counter-based: trip t draws from fold_in(sub, t), so any trip's
        # grid is computable independently of the others, and the key
        # evolution is trip-count-independent.
        key, sub = jax.random.split(key)

        def casc_cond(carry):
            colour, kind, key, elim, activated, new, trunc, it = carry
            return has_any_line(cfg, colour, kind) & (it < cfg.max_cascades)

        def casc_body(carry):
            colour, kind, key, elim, activated, new, trunc, it = carry
            if cfg.any_special:
                colour, kind, elim_d, act_d, new_d, ovf = specials_cascade_trip(
                    cfg, colour, kind, sub, it
                )
                return (
                    colour, kind, key, elim + elim_d, activated + act_d,
                    new + new_d, trunc | ovf, it + 1,
                )
            else:
                # With no specials enabled, one trip deletes exactly the
                # union of the detected lines' cells — computed directly as
                # a mask (no LineSet/classify materialisation; the trip
                # collapses to ~10 vector ops).  Equivalence with the slot
                # pipeline is asserted by tests/ops/test_lines_diff.py's
                # union tests.  No capacity caps on this path.
                dmask = line_union_mask(cfg, colour)
                colour = jnp.where(dmask, 0, colour)
                kind = jnp.where(dmask, 0, kind)
                act_d = jnp.int32(0)
                new_d = jnp.int32(0)
            elim = elim + flat - jnp.count_nonzero(kind).astype(jnp.int32)
            colour, kind = gravity(colour, kind)
            grid = draw_colour_grid(jax.random.fold_in(sub, it), cfg)
            colour, kind = apply_refill(colour, kind, grid)
            return (
                colour, kind, key, elim, activated + act_d, new + new_d,
                trunc, it + 1,
            )

        with jax.named_scope("cascade"):
            colour, kind, key, elim, activated, new, trunc, trips = (
                jax.lax.while_loop(
                    casc_cond,
                    casc_body,
                    (
                        colour, kind, key, elim, activated, jnp.int32(0),
                        trunc, jnp.int32(0),
                    ),
                )
            )
        # lines surviving the loop exit = the cascade cap truncated them
        trunc = trunc | has_any_line(cfg, colour, kind)

        # new specials filled holes → count as eliminations (`board.py:378`).
        elim = elim + new

        # playability loop (`board.py:381-391`): initial line state is empty.
        with jax.named_scope("playability"):
            colour, kind, key, shuffled, post_mask, gave_up = make_playable(
                cfg, colour, kind, key, jnp.asarray(False), jnp.int32(0)
            )
        return (
            colour, kind, key, elim, comb, new, activated, shuffled,
            post_mask, trunc | gave_up, trips,
        )

    return jax.lax.cond(eff, do_move, no_op, (colour, kind, key))


def reset(cfg: EnvConfig, key) -> Tuple[EnvState, StepInfo]:
    """``TileMatchEnv.reset`` (`tile_match_env.py:84-91`)."""
    colour, kind, key, mask, gave_up = generate_board(cfg, key)
    state = EnvState(colour=colour, kind=kind, timer=jnp.int32(0), key=key)
    info = StepInfo(
        is_combination_match=jnp.asarray(False),
        num_new_specials=jnp.int32(0),
        num_specials_activated=jnp.int32(0),
        shuffled=jnp.asarray(False),
        effective_actions=mask,
        truncated=gave_up,
        cascade_trips=jnp.int32(0),
    )
    return state, info


def step(
    cfg: EnvConfig,
    state: EnvState,
    action,
    eff_mask=None,
    compute_post_mask: bool = True,
) -> Tuple[EnvState, jnp.ndarray, jnp.ndarray, StepInfo]:
    """``TileMatchEnv.step`` (`tile_match_env.py:93-112`).

    Returns (next_state, reward, done, info).  Reward is the raw elimination
    count (`board.py:395` → `tile_match_env.py:112`).

    ``eff_mask``: optional precomputed effective-action mask for the CURRENT
    state (the mask the previous step's info already carries) — passing it
    avoids recomputing the largest kernel of the step twice per transition.

    ``compute_post_mask``: static; when False the returned
    ``info.effective_actions`` is the raw post-move mask (NOT zeroed on
    done) — used by the auto-resetting batched env, which substitutes the
    regenerated boards' masks for finished episodes itself.
    """
    c1_tab, c2_tab = action_table(cfg)
    c1 = jnp.asarray(c1_tab)[action]
    c2 = jnp.asarray(c2_tab)[action]

    mask_before = (
        effective_mask_settled(cfg, state.colour, state.kind)
        if eff_mask is None
        else eff_mask
    )
    eff = mask_before[action]

    (
        colour, kind, key, elim, comb, new, act, shuffled, post_mask, trunc,
        trips,
    ) = engine_move(
        cfg, state.colour, state.kind, state.key, c1, c2, eff, mask_before
    )

    timer = state.timer + 1
    done = timer >= cfg.num_moves
    next_state = EnvState(colour=colour, kind=kind, timer=timer, key=key)

    # `tile_match_env.py:118-124`: effective actions are empty once the
    # episode is over.  The mask itself is a by-product of the playability
    # loop inside engine_move — no extra kernel here.
    if compute_post_mask:
        mask_after = jnp.where(
            done, jnp.zeros((cfg.num_actions,), bool), post_mask
        )
    else:
        mask_after = post_mask
    info = StepInfo(
        is_combination_match=comb,
        num_new_specials=new,
        num_specials_activated=act,
        shuffled=shuffled,
        effective_actions=mask_after,
        truncated=trunc,
        cascade_trips=trips,
    )
    return next_state, elim, done, info


def observe(cfg: EnvConfig, state: EnvState):
    """Dict-style observation (`tile_match_env.py:114-115`)."""
    return {
        "board": state.board,
        "num_moves_left": cfg.num_moves - state.timer,
    }
