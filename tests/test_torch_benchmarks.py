"""The port's benchmark files against the JAX package's.

``benchmarks/torch_fig2a.py`` and ``torch_fig2b.py`` sweep the port's
simulator; ``benchmarks/torch_ablation.py`` serves the ablation grid on the
port's engine (here on the CPU, on the reference's reduced llama-7b weights
converted to torch).  Each must print the reference module's ``run()``
lines, and its rows must equal the reference's at 1e-9, the ``exact``
column included.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from benchmarks import ablation, fig2a, fig2b  # noqa: E402
from benchmarks import torch_ablation, torch_fig2a, torch_fig2b  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from test_torch_engine import _close  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("port,ref", [(torch_fig2a, fig2a), (torch_fig2b, fig2b)],
                         ids=["fig2a", "fig2b"])
def test_fig2_rows_equal_the_reference(port, ref):
    got, want = port.sweep(n_contexts=40), ref.sweep(n_contexts=40)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        _close(g, w, "row")
    assert port.run() == ref.run()


def test_ablation_rows_equal_the_reference():
    """The reference's ``sweep()`` draws its weights from
    ``PRNGKey(0)``; the port's serves the same weights, converted."""
    jcfg = jreduced(jget_config("llama-7b"))
    jparams = jregistry.get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(reduced_config(get_config("llama-7b")),
                             jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    got = torch_ablation.sweep(device="cpu", params=params)
    want = ablation.sweep()
    assert [r["config"] for r in got] == [r["config"] for r in want]
    for g, w in zip(got, want):
        assert g["tokens_exact"] == w["tokens_exact"], g["config"]
        _close(g, w, g["config"])
    assert torch_ablation.lines(got) == ablation.run()
