"""The port's entry points (``ompi_tpu_torch/graft_entry.py``)
against the JAX package's ``__graft_entry__.py``, on the CPU.

- ``_tiny_cfg`` is the JAX package's, field for field (the dtype in
  each package's own type).
- ``entry(device="cpu")``: the one-rank forward; with the JAX
  package's parameters carried across, its loss within rtol 1e-5 of the
  JAX ``entry()`` function's.
- ``dryrun_multichip(8, device="cpu")``: the (2, 2, 2) mesh, two
  finite training steps, a vtable allreduce, the kernel tier (the
  PallasColl allreduce and the fused ring attention against the xla
  path, their plain versions here) and the summary line, which says
  that the spanning-communicator part is not ported. The JAX dry run
  itself is not run here: it resets the JAX backends and starts two
  controller processes.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
import ompi_tpu_torch
from ompi_tpu_torch import graft_entry as tentry
from ompi_tpu_torch.models import transformer as TT


@pytest.mark.parametrize("tp,pp,dp", [(1, 1, 1), (2, 2, 2), (4, 2, 1)])
def test_tiny_cfg_matches_jax(tp, pp, dp):
    j = dataclasses.asdict(jentry._tiny_cfg(tp, pp, dp))
    t = dataclasses.asdict(tentry._tiny_cfg(tp, pp, dp))
    assert j.pop("dtype") == jax.numpy.float32
    assert t.pop("dtype") == torch.float32
    assert j == t


def test_entry_matches_jax():
    fn, (params, tokens, targets) = tentry.entry(device="cpu")
    assert params["blocks"]["wq"].device.type == "cpu"
    loss = float(fn(params, tokens, targets))
    assert math.isfinite(loss)
    jfn, (jparams, jtokens, jtargets) = jentry.entry()
    assert np.array_equal(np.asarray(jtokens), tokens.numpy())
    mesh = TT.demo_mesh(1, device="cpu")
    carried = TT.params_from_jax(jax.tree.map(np.asarray, jparams),
                                 tentry._tiny_cfg(1, 1, 1), mesh)
    np.testing.assert_allclose(float(fn(carried, tokens, targets)),
                               float(jfn(jparams, jtokens, jtargets)),
                               rtol=1e-5)


def test_dryrun_multichip(capsys):
    try:
        line = tentry.dryrun_multichip(8, device="cpu")
    finally:
        ompi_tpu_torch.finalize()
    assert line.startswith("dryrun_multichip ok: mesh dp=2 pp=2 tp=2, loss ")
    losses = line.split("loss ")[1].split(";")[0].split(" -> ")
    assert all(math.isfinite(float(x)) for x in losses)
    assert "pallas tier: allreduce via coll/pallas vtable (n=8)" in line
    assert line.endswith("spanning comm: not ported (ROADMAP Queue 1 "
                         "item 8)")
    assert capsys.readouterr().out.strip() == line
