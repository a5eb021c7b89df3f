"""The models' KV-length-sharded attention (the reference's route under
``REPRO_ATTN_KV_SHARD=1`` with a ``model`` axis) on gloo ranks spawned from
the test (``torch_dist_ranks.spawn``, case ``kv_shard_model``), held to the
reference's single-device prefill and greedy decode on the same converted
weights:

  * reduced jamba (its attention layer's cache length-sharded over 2 and
    4 ranks, the Mamba states whole): a prefill, a suffix prefill and 8
    decode steps through ``lm.prefill`` / ``lm.decode(kv_group=...)``;
  * reduced mixtral's sliding-window ring (16 rows, 8 or 4 a rank): a
    prefill of 24 tokens, whose ``[ring ++ new]`` rows divide over the
    ranks (each attends its ring rows and its share of the new ones), then
    8 decode steps;
  * shapes that do not divide: a jamba cache of 66 rows over 4 ranks
    (``lm.shard_state`` gives None and the whole state decodes unsharded,
    as the reference's ``_mesh_axes_for_kv_shard`` returns None), and a
    ring prefill of 21 tokens, whose ``16 + 21`` rows do not divide, so the
    ring's shards are gathered and attention runs unsharded.

Logits within 2e-5 of the reference's (the attention tolerance of the
North star), greedy tokens equal.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from torch_dist_ranks import spawn  # noqa: E402

ATOL = 2e-5
JAMBA, MIXTRAL = "jamba-1.5-large-398b", "mixtral-8x22b"
STEPS = 8


@functools.lru_cache(maxsize=None)
def _reference(arch):
    jcfg = jreduced(jget_config(arch))
    return jcfg, jregistry.get_model(jcfg).init(jax.random.PRNGKey(3), jcfg)


def _prompts(arch, lengths, seed):
    vocab = _reference(arch)[0].vocab
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (2, n)).astype(np.int32) for n in lengths]


SCENARIOS = {
    "jamba": dict(arch=JAMBA, batch=2, max_len=64, prompts=_prompts(JAMBA, (24, 8), 0),
                  steps=STEPS, ranks=(2, 4)),
    "jamba-undivided": dict(arch=JAMBA, batch=2, max_len=66, prompts=_prompts(JAMBA, (24,), 1),
                            steps=STEPS, ranks=(4,)),
    "mixtral-ring": dict(arch=MIXTRAL, batch=2, max_len=64, prompts=_prompts(MIXTRAL, (24,), 2),
                         steps=STEPS, ranks=(2, 4)),
    "mixtral-ring-undivided": dict(arch=MIXTRAL, batch=2, max_len=64,
                                   prompts=_prompts(MIXTRAL, (21,), 3), steps=STEPS,
                                   ranks=(2, 4)),
}


@functools.lru_cache(maxsize=None)
def _reference_run(name):
    """The reference's single-device prefill(s) and greedy decode."""
    sc = SCENARIOS[name]
    jcfg, jparams = _reference(sc["arch"])
    api = jregistry.get_model(jcfg)
    prefill = jax.jit(api.prefill, static_argnums=1)
    decode = jax.jit(api.decode, static_argnums=1)
    state = api.init_state(jcfg, sc["batch"], sc["max_len"])
    logits = []
    for part in sc["prompts"]:
        lg, state = prefill(jparams, jcfg, jnp.asarray(part), state)
        logits.append(np.asarray(lg))
    tok = np.argmax(logits[-1], -1)[:, None].astype(np.int32)
    tokens = [tok]
    for _ in range(sc["steps"]):
        lg, state = decode(jparams, jcfg, jnp.asarray(tok), state)
        logits.append(np.asarray(lg))
        tok = np.argmax(logits[-1], -1)[:, None].astype(np.int32)
        tokens.append(tok)
    return logits, tokens


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    params = {a: jax.tree_util.tree_map(np.asarray, _reference(a)[1]) for a in (JAMBA, MIXTRAL)}
    outs = spawn("kv_shard_model", 4, tmp_path_factory.mktemp("kv_shard_model"),
                 dict(params=params, scenarios=SCENARIOS))
    return outs


@pytest.mark.parametrize("name,n", [(name, n) for name, sc in SCENARIOS.items()
                                    for n in sc["ranks"]])
def test_sharded_prefill_and_decode_match_reference(ranks, name, n):
    sc = SCENARIOS[name]
    want_logits, want_tokens = _reference_run(name)
    for r in range(n):
        got = ranks[r][(name, n)]
        assert len(got["logits"]) == len(want_logits) == len(sc["prompts"]) + STEPS
        for i, (g, w) in enumerate(zip(got["logits"], want_logits)):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=f"rank {r} call {i}")
        for g, w in zip(got["tokens"], want_tokens):
            np.testing.assert_array_equal(g, w)
    # every rank of the group holds the same logits, bit for bit
    for r in range(1, n):
        for a, b in zip(ranks[0][(name, n)]["logits"], ranks[r][(name, n)]["logits"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,n,sharded,gathers", [
    ("jamba", 2, True, 0), ("jamba", 4, True, 0),
    ("jamba-undivided", 4, False, 0),
    ("mixtral-ring", 2, True, 0), ("mixtral-ring", 4, True, 0),
    # one ring prefill per layer gathers the ring's K and V shards
    ("mixtral-ring-undivided", 2, True, 4), ("mixtral-ring-undivided", 4, True, 4),
])
def test_route_taken_where_the_reference_takes_it(ranks, name, n, sharded, gathers):
    """The sharded route where the rows divide; the whole state (66 rows on
    4 ranks) or the gathered ring (16 + 21 rows) where they do not."""
    got = ranks[0][(name, n)]
    assert got["sharded"] is sharded
    assert got["gathers"] == gathers
