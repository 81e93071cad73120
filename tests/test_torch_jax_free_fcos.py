"""The ``fcos`` part of the port's CPU slice with jax and the JAX package
blocked (``test_torch_jax_free.py``'s ``PARTS``), in a file of its own so
that ``--dist loadfile`` runs it beside the other parts."""

from test_torch_jax_free import run_part


def test_port_runs_fcos_without_jax(tmp_path):
    run_part("fcos", tmp_path)
