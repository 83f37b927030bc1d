"""The batched env and the parity engine import and run without flax,
gymnasium or pygame, which are optional extras."""

import os
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BLOCK = "import sys\nfor m in ('flax', 'gymnasium', 'pygame'):\n    sys.modules[m] = None\n"

_SCRIPTS = {
    "batched": """
import jax, numpy as np
from tile_match_tpu.config import EnvConfig
from tile_match_tpu.envs.batched import batched_reset, batched_step
cfg = EnvConfig(5, 5, 3, 4)
states, ts = batched_reset(cfg, jax.random.PRNGKey(0), 4)
actions = ts.info.effective_actions.argmax(-1).astype('int32')
states, ts = batched_step(cfg, states, actions, eff_mask=ts.info.effective_actions)
assert ts.reward.shape == (4,) and bool((ts.reward >= 3).all())
assert 'flax' not in {m.split('.')[0] for m, v in sys.modules.items() if v}
print('ok')
""",
    "parity": """
import numpy as np
from tile_match_tpu.config import EnvConfig
from tile_match_tpu.parity import ParityEngine
eng = ParityEngine(EnvConfig(5, 5, 3, 4), np.random.default_rng(2))
eng.generate_board()
assert eng.possible_move()
print('ok')
""",
}


@pytest.mark.parametrize("entry", sorted(_SCRIPTS))
def test_main_path_runs_without_optional_packages(entry):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", _BLOCK + _SCRIPTS[entry]],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
