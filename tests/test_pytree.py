"""The frozen pytree dataclass behind EnvState, StepInfo, TimeStep, LineSet,
Matches and Replay."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tile_match_tpu.config import EnvConfig
from tile_match_tpu.engine import reset, step
from tile_match_tpu.envs.batched import batched_reset
from tile_match_tpu.models.replay import replay_init
from tile_match_tpu.ops.classify import process_colour_lines
from tile_match_tpu.ops.lines import get_colour_lines
from tile_match_tpu.pytree import pytree_dataclass
from tile_match_tpu.state import EnvState, StepInfo

CFG = EnvConfig(5, 5, 3, 4)


def _instances():
    state, info = reset(CFG, jax.random.PRNGKey(0))
    _, ts = batched_reset(CFG, jax.random.PRNGKey(1), 2)
    colour = jnp.asarray(np.tile([[1, 1, 1, 2, 3], [2, 3, 2, 3, 2]], (3, 1))[:5])
    ls = get_colour_lines(CFG, colour, jnp.ones_like(colour))
    return {
        "EnvState": state,
        "StepInfo": info,
        "TimeStep": ts,
        "LineSet": ls,
        "Matches": process_colour_lines(CFG, colour, ls),
        "Replay": replay_init(CFG, 4),
    }


@pytest.mark.parametrize(
    "name", ["EnvState", "StepInfo", "TimeStep", "LineSet", "Matches", "Replay"]
)
def test_flatten_unflatten_round_trip(name):
    obj = _instances()[name]
    leaves, treedef = jax.tree.flatten(obj)
    n_fields = len(dataclasses.fields(obj))
    assert len(jax.tree.leaves(obj, is_leaf=lambda x: x is not obj)) == n_fields
    back = jax.tree.unflatten(treedef, leaves)
    assert type(back) is type(obj)
    for a, b in zip(jax.tree.leaves(back), leaves):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    doubled = jax.tree.map(lambda x: x, obj)
    assert jax.tree.structure(doubled) == treedef


def test_replace_returns_a_copy_and_instances_are_frozen():
    state = _instances()["EnvState"]
    later = state.replace(timer=state.timer + 3)
    assert int(later.timer) == int(state.timer) + 3
    assert int(state.timer) == 0
    assert later.colour is state.colour
    with pytest.raises(dataclasses.FrozenInstanceError):
        state.timer = 1
    with pytest.raises(TypeError):
        state.replace(no_such_field=1)


def test_defaults_are_leaves():
    info = StepInfo(
        is_combination_match=False,
        num_new_specials=0,
        num_specials_activated=0,
        shuffled=False,
        effective_actions=jnp.zeros((3,), bool),
    )
    assert info.truncated is False and info.cascade_trips == 0
    assert len(jax.tree.leaves(info)) == 7


@pytest.mark.parametrize("transform", ["jit", "vmap", "scan"])
def test_env_state_through_transforms(transform):
    state, info = reset(CFG, jax.random.PRNGKey(2))
    mask = info.effective_actions
    action = jnp.argmax(mask).astype(jnp.int32)

    def one(s):
        return step(CFG, s, action, eff_mask=mask)[0]

    want = one(state)
    if transform == "jit":
        got = jax.jit(one)(state)
    elif transform == "vmap":
        batch = jax.tree.map(lambda x: jnp.stack([x, x]), state)
        got = jax.tree.map(lambda x: x[1], jax.vmap(one)(batch))
    else:
        got, seen = jax.lax.scan(lambda s, _: (one(s), s.timer), state, None, length=1)
        assert np.array_equal(np.asarray(seen), [0])
    assert isinstance(got, EnvState)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_decorated_class_is_a_registered_dataclass():
    @pytree_dataclass
    class Pair:
        a: jnp.ndarray
        b: jnp.ndarray = 0

    p = Pair(jnp.ones(2))
    assert dataclasses.is_dataclass(p)
    out = jax.jit(lambda p: p.replace(b=p.a.sum()))(p)
    assert isinstance(out, Pair) and float(out.b) == 2.0
