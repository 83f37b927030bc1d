"""Greedy match classification: fixed-shape machine for ``process_colour_lines``.

Reference semantics (`board.py:269-327`), replicated exactly:

* lines are processed as a queue, initially stable-sorted by the row of each
  line's first (topmost) coordinate (`board.py:282`);
* pop front; greedy priority: cookie (len>=5, enabled) → laser (len==4) →
  bomb (enabled, shares a coord with another queued line) → normal (len>=3);
* cookie consumes the first 5 coords and re-appends the remainder if longer
  than 2 (`board.py:287-292`);
* a horizontal 4-line falls back to a vertical laser when horizontal lasers
  are disabled but vertical ones are enabled (`board.py:297-302` quirk);
* bomb takes the whole line plus the 3 partner-line coords closest (Manhattan,
  stable) to the first shared coord; the partner is dropped when shorter than
  6, else those 3 coords are removed from it (`board.py:304-320`).

Instead of Python lists, the queue lives in fixed slot arrays with integer
order keys: pop = argmin(order), append = fresh slot with a monotonically
increasing key, remove = key := BIG.  The whole machine is one
``lax.while_loop`` with masked vector updates, so it jits and vmaps.

Implementation notes:

* Shared-coordinate tests run on per-line membership **bitboards**
  (``bmask: bool[LM2, R*C]``), kept incrementally updated through cookie
  re-appends and bomb partner-shrinks.  All coordinate-set operations become
  elementwise AND/any reductions instead of index scatters and gathers.
* Match capacity is ``MM = LM2``: every emit consumes one pop and each pop
  kills one slot, so emits can never exceed the LM2 total slots ever alive —
  ``mcount`` cannot overflow by construction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as _np

from ..config import (
    EnvConfig,
    MATCH_BOMB,
    MATCH_COOKIE,
    MATCH_H_LASER,
    MATCH_NORMAL,
    MATCH_V_LASER,
)
from ..pytree import pytree_dataclass
from .lines import LineSet
from .runs import BIG


@pytree_dataclass
class Matches:
    coords: jnp.ndarray  # i32[MM, CM, 2]; (-1,-1) padded
    length: jnp.ndarray  # i32[MM]
    mtype: jnp.ndarray  # i32[MM] (MATCH_* codes)
    mcolour: jnp.ndarray  # i32[MM]
    count: jnp.ndarray  # i32 scalar
    ovf: jnp.ndarray = False  # bool: queue append or emission capacity hit


def _coord_eq(a, b):
    """a: [..., 2], b: [..., 2] broadcastable → elementwise coord equality."""
    return (a[..., 0] == b[..., 0]) & (a[..., 1] == b[..., 1])


def process_colour_lines(cfg: EnvConfig, colour, lineset: LineSet) -> Matches:
    LM = cfg.lines_max
    L = cfg.line_len_max
    LM2 = 2 * LM  # initial slots + append slots
    CM = cfg.match_coords_max
    MM = LM2  # emits <= pops <= total slots ever alive = LM2
    R, C = cfg.num_rows, cfg.num_cols
    RC = R * C

    # --- working queue -----------------------------------------------------
    lc = jnp.full((LM2, L, 2), -1, jnp.int32)
    lc = lc.at[:LM].set(lineset.coords)
    ll = jnp.zeros((LM2,), jnp.int32).at[:LM].set(lineset.length)
    slot_ids = jnp.arange(LM2, dtype=jnp.int32)
    alive0 = (slot_ids < lineset.count) & (ll > 0)
    top_row = lc[:, 0, 0]
    lo = jnp.where(alive0, top_row * LM + slot_ids[:LM2], BIG)

    m_coords = jnp.full((MM, CM, 2), -1, jnp.int32)
    m_len = jnp.zeros((MM,), jnp.int32)
    m_type = jnp.zeros((MM,), jnp.int32)
    m_colour = jnp.zeros((MM,), jnp.int32)

    cell_ids = jnp.arange(RC, dtype=jnp.int32)
    cell_r = cell_ids // C
    cell_c = cell_ids % C

    if cfg.bomb:
        # Per-line membership bitboards.  Detected lines are straight
        # ascending runs (`lines.py` contract), so each line's cell set is
        # derived from (first coord, length, orientation) with pure
        # elementwise compares — no scatter.
        f0r, f0c = lc[:, 0, 0], lc[:, 0, 1]
        vert = alive0 & (lc[:, 1, 1] == f0c)
        in_v = (
            (cell_c[None, :] == f0c[:, None])
            & (cell_r[None, :] >= f0r[:, None])
            & (cell_r[None, :] < (f0r + ll)[:, None])
        )
        in_h = (
            (cell_r[None, :] == f0r[:, None])
            & (cell_c[None, :] >= f0c[:, None])
            & (cell_c[None, :] < (f0c + ll)[:, None])
        )
        bmask = alive0[:, None] & jnp.where(vert[:, None], in_v, in_h)
    else:
        bmask = None

    # ---- split: independent lines (vectorised) vs shared lines (machine) --
    # The queue machine exists for ONE interaction: bomb pairing (a popped
    # line consuming coords of a still-queued partner).  A line with no
    # shared coordinate can never be or have a partner, so it classifies
    # independently — cookie (first 5, remainder re-queued after all initial
    # lines), laser (len 4, orientation quirk), normal — all computable in
    # one vectorised shot, including multi-level cookie splitting.  ONLY the
    # genuinely-sharing lines go through the while_loop machine; the two
    # emission streams are merged afterwards by (level, root-key), which is
    # exactly the sequential pop order (appends key strictly after all
    # initial lines, level by level, parents in key order).  Under vmap this
    # cuts the machine's trip count to the worst board's SHARED-line pops.
    if cfg.bomb:
        # a line is shared ⟺ one of its cells is covered by >= 2 bitboards.
        # Conservative for remainders: they are subsets of their parents, so
        # any runtime share implies an initial share.
        cnt = jnp.sum(bmask.astype(jnp.int32), axis=0)
        shared = alive0 & jnp.any(bmask & (cnt >= 2)[None, :], axis=1)
    else:
        shared = jnp.zeros((LM2,), bool)
    fast_live0 = alive0 & ~shared
    KSPAN = (R + 2) * LM  # > any initial order key (top_row*LM + slot)

    # Slot order, NOT sorted: the merge below orders every emission by its
    # key anyway, so the fast side needs no argsort and no permutation
    # gathers.
    f_live = fast_live0  # independent-line liveness, slot order
    f_root = jnp.where(f_live, lo, BIG)  # root order keys
    f_len0 = jnp.where(f_live, ll, 0)
    f_coords_L = jnp.where(f_live[:, None, None], lc, -1)  # [LM2, L, 2]
    fr0 = jnp.clip(f_coords_L[:, 0, 0], 0, R - 1)
    fc0 = jnp.clip(f_coords_L[:, 0, 1], 0, C - 1)
    # first-coord colour via a one-hot multiply-reduce over the cells
    # (equivalent to a [LM2]-index gather)
    ord0 = fr0 * C + fc0  # [LM2]
    f_colour0 = jnp.where(
        f_live,
        jnp.sum(
            (ord0[:, None] == cell_ids[None, :]) * colour.reshape(-1)[None, :],
            axis=1,
        ),
        0,
    )
    f_is_h = f_coords_L[:, 0, 0] == f_coords_L[:, 1, 0]
    f_laser_t = jnp.where(
        f_is_h & cfg.horizontal_laser,
        MATCH_H_LASER,
        jnp.where(cfg.vertical_laser, MATCH_V_LASER, MATCH_NORMAL),
    )

    # Level k = the k-th cookie remainder of an initial line (level 0).  A
    # line splits while cookie applies and the remainder is > 2 long; each
    # remainder re-queues after every already-queued line, so emission order
    # is level-major, preserving the sorted initial order within each level
    # (order keys: initial < 1st-level appends < 2nd-level, `board.py:
    # 282-292` semantics).
    NL = 1 + max(0, (L - 3) // 5) if cfg.cookie else 1
    cm_ids = jnp.arange(CM, dtype=jnp.int32)
    lev_live, lev_len, lev_type, lev_colour, lev_coords, lev_key = (
        [], [], [], [], [], [],
    )
    live_k = f_live
    len_k = f_len0
    for k in range(NL):
        is_cookie = (
            live_k & (len_k >= 5) if cfg.cookie else jnp.zeros_like(live_k)
        )
        keep = jnp.where(is_cookie, 5, len_k)
        typ = jnp.where(
            is_cookie,
            MATCH_COOKIE,
            jnp.where(live_k & (len_k == 4), f_laser_t, MATCH_NORMAL),
        )
        colr = jnp.where(is_cookie, 0, f_colour0)
        # coords: slice [5k, 5k+keep) of the original line (static shift)
        src = _np.minimum(_np.arange(CM) + 5 * k, L - 1)
        shifted = f_coords_L[:, src, :]  # [LM2, CM, 2]
        emit_mask = (cm_ids[None, :] < keep[:, None]) & live_k[:, None]
        sel_c = jnp.where(emit_mask[:, :, None], shifted, -1)
        lev_live.append(live_k)
        lev_len.append(jnp.where(live_k, keep, 0))
        lev_type.append(jnp.where(live_k, typ, 0))
        lev_colour.append(jnp.where(live_k, colr, 0))
        lev_coords.append(sel_c)
        lev_key.append(jnp.where(live_k, k * KSPAN + f_root, BIG))
        rem = len_k - 5
        live_k = is_cookie & (rem > 2)
        len_k = jnp.where(live_k, rem, 0)

    all_live = jnp.concatenate(lev_live)  # [NL*LM2]
    all_len = jnp.concatenate(lev_len)
    all_type = jnp.concatenate(lev_type)
    all_colour = jnp.concatenate(lev_colour)
    all_coords = jnp.concatenate(lev_coords)  # [NL*LM2, CM, 2]
    all_key = jnp.concatenate(lev_key)  # merge keys; BIG when dead

    # The machine only sees the shared lines.
    lo = jnp.where(shared, lo, BIG)

    # One extra DUMP slot per queue/emission array: conditional updates
    # redirect their index there when disabled, so every update is a
    # single-row dynamic write instead of a full-array select (the selects
    # copied the whole [LM2, ...] carry per pop and dominated the machine).
    DUMP = LM2
    lo = jnp.concatenate([lo, jnp.full((1,), BIG, jnp.int32)])
    lc = jnp.concatenate([lc, jnp.full((1, L, 2), -1, jnp.int32)])
    ll = jnp.concatenate([ll, jnp.zeros((1,), jnp.int32)])
    if cfg.bomb:
        bmask = jnp.concatenate([bmask, jnp.zeros((1, RC), bool)])
    slot_ids_m = jnp.arange(LM2 + 1, dtype=jnp.int32)

    def cond(carry):
        lo = carry[0]
        return jnp.any(lo < BIG)

    def body(carry):
        (
            lo, lc, ll, bmask, lroot, llev, atail, next_order,
            mc, mlen, mt, mcol, mkey, mcount, movf,
        ) = carry

        sel = jnp.argmin(lo)
        n = ll[sel]
        line = lc[sel]  # [L, 2]
        sel_root = lroot[sel]
        sel_lev = llev[sel]
        jj = jnp.arange(L, dtype=jnp.int32)
        in_line_n = jj < n
        # kill popped slot
        lo = lo.at[sel].set(BIG)
        ll = ll.at[sel].set(0)

        first = line[0]
        line_colour = colour[jnp.maximum(first[0], 0), jnp.maximum(first[1], 0)]

        cookie_case = jnp.asarray(cfg.cookie and True) & (n >= 5)
        laser_case = (~cookie_case) & (n == 4)

        # --- bomb partner search (only when bomb enabled: static prune) ----
        if cfg.bomb:
            pb = bmask[sel]  # popped line's cell set [RC]
            share_line = (
                jnp.any(bmask & pb[None, :], axis=1)
                & (lo < BIG)
                & (ll > 0)
                & (slot_ids_m < LM2)  # never the DUMP slot
            )
            exists_share = jnp.any(share_line)
            partner = jnp.argmin(jnp.where(share_line, lo, BIG))
            bomb_case = (
                (~cookie_case) & (~laser_case) & exists_share & (n >= 3)
            )
        else:
            bomb_case = jnp.asarray(False)
        normal_case = (~cookie_case) & (~laser_case) & (~bomb_case) & (n >= 3)

        emit = cookie_case | laser_case | bomb_case | normal_case

        # --- assemble emitted match ----------------------------------------
        out_c = jnp.full((CM, 2), -1, jnp.int32)
        cm_ids = jnp.arange(CM, dtype=jnp.int32)
        keep = jnp.where(cookie_case, jnp.minimum(n, 5), n)
        base = jnp.where(
            (cm_ids < keep)[:, None], lc[sel][jnp.minimum(cm_ids, L - 1)], -1
        )
        out_c = jnp.where((cm_ids < keep)[:, None], base, out_c)
        out_len = keep
        out_colour = jnp.where(cookie_case, 0, line_colour)

        if cfg.cookie:
            out_type_cookie = MATCH_COOKIE
        else:
            out_type_cookie = MATCH_NORMAL  # unreachable
        is_h = line[0, 0] == line[1, 0]
        laser_type = jnp.where(
            is_h & cfg.horizontal_laser,
            MATCH_H_LASER,
            jnp.where(cfg.vertical_laser, MATCH_V_LASER, MATCH_NORMAL),
        )
        out_type = jnp.where(
            cookie_case,
            out_type_cookie,
            jnp.where(laser_case, laser_type, MATCH_NORMAL),
        )

        # --- cookie remainder append ---------------------------------------
        rem_len = n - 5
        # a needed re-append with no free slot silently drops the cookie
        # line's remainder (`board.py:291-292` re-appends freely) — flagged
        # sticky for StepInfo.truncated, checked hard under debug_checks
        movf = movf | (cookie_case & (rem_len > 2) & (atail >= LM2))
        if cfg.debug_checks:
            from jax.experimental import checkify

            checkify.check(
                ~(cookie_case & (rem_len > 2) & (atail >= LM2)),
                "classify queue overflow: cookie remainder dropped",
            )
        do_append = cookie_case & (rem_len > 2) & (atail < LM2)
        rem = jnp.where(
            (jj < rem_len)[:, None], lc[sel][jnp.minimum(jj + 5, L - 1)], -1
        )
        app_idx = jnp.where(do_append, jnp.minimum(atail, LM2 - 1), DUMP)
        lc = lc.at[app_idx].set(rem)
        ll = ll.at[app_idx].set(jnp.where(do_append, rem_len, 0))
        # value guarded: the DUMP slot's key must stay BIG for the loop cond
        lo = lo.at[app_idx].set(jnp.where(do_append, next_order, BIG))
        lroot = lroot.at[app_idx].set(sel_root)
        llev = llev.at[app_idx].set(sel_lev + 1)
        if cfg.bomb:
            remo = (
                jnp.clip(rem[:, 0], 0, R - 1) * C + jnp.clip(rem[:, 1], 0, C - 1)
            )
            rbits = jnp.any(
                (cell_ids[None, :] == remo[:, None]) & (jj < rem_len)[:, None],
                axis=0,
            )
            bmask = bmask.at[app_idx].set(rbits)
        atail = atail + do_append.astype(jnp.int32)
        next_order = next_order + do_append.astype(jnp.int32)

        # --- bomb: extras + partner update ---------------------------------
        if cfg.bomb:
            # first shared coord in LINE order: line coords present in the
            # partner's cell set (bitboard lookup, no gather)
            pbits = bmask[partner]
            line_ord = (
                jnp.clip(line[:, 0], 0, R - 1) * C
                + jnp.clip(line[:, 1], 0, C - 1)
            )
            memb = (
                jnp.any(
                    (cell_ids[None, :] == line_ord[:, None]) & pbits[None, :],
                    axis=1,
                )
                & in_line_n
            )
            shared_j = jnp.argmax(memb)
            shared = line[shared_j]
            p_coords = lc[partner]
            p_len = ll[partner]
            dist = jnp.abs(p_coords[:, 0] - shared[0]) + jnp.abs(
                p_coords[:, 1] - shared[1]
            )
            kk = jnp.arange(L, dtype=jnp.int32)
            # stable sort by (distance, list position); invalid slots sort last
            sort_key = jnp.where(kk < p_len, dist * L + kk, BIG)
            rank = jnp.argsort(sort_key)
            dist = jnp.where(kk < p_len, dist, BIG)
            sel3 = rank[:3]  # indices of the 3 closest partner coords
            sel3_coords = p_coords[sel3]  # [3, 2] in closeness order
            sel3_valid = dist[sel3] < BIG
            # extras: sel3 coords not already in line
            in_line = jnp.any(
                _coord_eq(sel3_coords[:, None, :], line[None, :, :])
                & in_line_n[None, :],
                axis=1,
            )
            extra_ok = sel3_valid & (~in_line)
            # 3-element cumsum, unrolled
            e_i = extra_ok.astype(jnp.int32)
            extra_pos = n + jnp.stack(
                [e_i[0], e_i[0] + e_i[1], e_i[0] + e_i[1] + e_i[2]]
            ) - 1
            bomb_c = out_c
            for t in range(3):
                pos = jnp.minimum(extra_pos[t], CM - 1)
                bomb_c = jnp.where(
                    extra_ok[t], bomb_c.at[pos].set(sel3_coords[t]), bomb_c
                )
            bomb_len = n + jnp.sum(extra_ok.astype(jnp.int32))
            out_c = jnp.where(bomb_case, bomb_c, out_c)
            out_len = jnp.where(bomb_case, bomb_len, out_len)
            out_type = jnp.where(bomb_case, MATCH_BOMB, out_type)

            # partner update
            drop_partner = bomb_case & (p_len < 6)
            drop_idx = jnp.where(drop_partner, partner, DUMP)
            lo = lo.at[drop_idx].set(BIG)
            ll = ll.at[drop_idx].set(0)
            shrink = bomb_case & (p_len >= 6)
            removed = jnp.zeros((L,), bool)
            for t in range(3):
                removed = removed | (kk == sel3[t])
            keep_mask = (~removed) & (kk < p_len)
            # stable compaction of kept coords (dropped ones scatter to the
            # spill slot L, which is trimmed off); cumsum via triangular
            # multiply-reduce
            tri = kk[:, None] >= kk[None, :]  # [L, L]
            dest = (
                jnp.sum(tri * keep_mask.astype(jnp.int32)[None, :], axis=1) - 1
            )
            scatter_idx = jnp.where(keep_mask, dest, L)
            new_p = (
                jnp.full((L + 1, 2), -1, jnp.int32).at[scatter_idx].set(p_coords)[:L]
            )
            shrink_idx = jnp.where(shrink, partner, DUMP)
            lc = lc.at[shrink_idx].set(new_p)
            ll = ll.at[shrink_idx].set(jnp.where(shrink, p_len - 3, 0))
            # shrink p_len >= 6 ⇒ all sel3 valid ⇒ remove their cells
            sel3_ord = (
                jnp.clip(sel3_coords[:, 0], 0, R - 1) * C
                + jnp.clip(sel3_coords[:, 1], 0, C - 1)
            )
            rm = jnp.any(cell_ids[None, :] == sel3_ord[:, None], axis=0)
            bmask = bmask.at[shrink_idx].set(pbits & ~rm)

        # --- write emitted match -------------------------------------------
        # mcount <= pops <= LM2 = MM, so the min() clamp never actually
        # bites; non-emitting pops write to the MM dump slot.
        mslot = jnp.where(emit, jnp.minimum(mcount, MM - 1), MM)
        mc = mc.at[mslot].set(out_c)
        mlen = mlen.at[mslot].set(out_len)
        mt = mt.at[mslot].set(out_type)
        mcol = mcol.at[mslot].set(out_colour)
        mkey = mkey.at[mslot].set(sel_lev * KSPAN + sel_root)
        mcount = mcount + emit.astype(jnp.int32)

        return (
            lo, lc, ll, bmask, lroot, llev, atail, next_order,
            mc, mlen, mt, mcol, mkey, mcount, movf,
        )

    if not cfg.bomb:
        # keep the carry a fixed pytree: a scalar stand-in for bmask
        bmask = jnp.int32(0)

    init = (
        lo,
        lc,
        ll,
        bmask,
        lo,  # lroot: a line's root key is its own initial key (padded)
        jnp.zeros((LM2 + 1,), jnp.int32),  # llev (padded with dump slot)
        jnp.int32(LM),
        jnp.int32(KSPAN),
        jnp.concatenate([m_coords, jnp.full((1, CM, 2), -1, jnp.int32)]),
        jnp.concatenate([m_len, jnp.zeros((1,), jnp.int32)]),
        jnp.concatenate([m_type, jnp.zeros((1,), jnp.int32)]),
        jnp.concatenate([m_colour, jnp.zeros((1,), jnp.int32)]),
        jnp.full((MM + 1,), BIG, jnp.int32),  # mkey (padded)
        jnp.int32(0),
        jnp.asarray(False),  # movf: sticky append-overflow flag
    )
    out = jax.lax.while_loop(cond, body, init)
    (_, _, _, _, _, _, _, _, mc, mlen, mt, mcol, mkey, mcount, movf) = out
    # trim the dump slots
    mc, mlen, mt, mcol, mkey = (
        mc[:MM], mlen[:MM], mt[:MM], mcol[:MM], mkey[:MM],
    )

    # ---- merge the two emission streams by (level, root key) --------------
    # The independent stream carries its keys in all_key; the machine stream
    # in mkey (BIG beyond mcount).  Keys are globally unique and sorting by
    # them reproduces the sequential pop order exactly.
    mkey = jnp.where(jnp.arange(MM) < mcount, mkey, BIG)
    cat_key = jnp.concatenate([all_key, mkey])  # [NF + MM]
    cat_len = jnp.concatenate([all_len, mlen])
    cat_type = jnp.concatenate([all_type, mt])
    cat_colour = jnp.concatenate([all_colour, mcol])
    cat_coords = jnp.concatenate([all_coords, mc])  # [NF+MM, CM, 2]
    # total emissions beyond MM would be silently truncated by the
    # perm[:MM] slice below (cannot happen within the append budget:
    # fast + machine emissions together mirror sequential pops <= LM2)
    emit_ovf = jnp.sum((cat_key < BIG).astype(jnp.int32)) > MM
    if cfg.debug_checks:
        from jax.experimental import checkify

        checkify.check(
            ~emit_ovf,
            "classify emission overflow: more than MM live matches",
        )
    perm = jnp.argsort(cat_key)[:MM]  # total live emissions <= MM
    oh = (
        jnp.arange(cat_key.shape[0], dtype=jnp.int32)[None, :] == perm[:, None]
    ) & (cat_key[None, :] < BIG)  # [MM, NF+MM] one-hot, dead rows all-zero
    oh_i = oh.astype(jnp.int32)
    out_len = jnp.sum(oh_i * cat_len[None, :], axis=1)
    out_type = jnp.sum(oh_i * cat_type[None, :], axis=1)
    out_colour = jnp.sum(oh_i * cat_colour[None, :], axis=1)
    flatc = cat_coords.reshape(-1, CM * 2)  # [NF+MM, CM*2]
    out_coords = (
        jnp.einsum("ms,sc->mc", oh_i, flatc + 1).reshape(MM, CM, 2) - 1
    )  # +1/-1 keeps (-1,-1) padding exact through the zero-sum dead slots
    out_count = jnp.sum((all_key < BIG).astype(jnp.int32)) + mcount
    return Matches(
        coords=out_coords,
        length=out_len,
        mtype=out_type,
        mcolour=out_colour,
        count=out_count,
        ovf=movf | emit_ovf | lineset.ovf,
    )
