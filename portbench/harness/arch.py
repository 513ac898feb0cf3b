"""What an architecture adapter gives the harness.

A configuration file names its architecture (``"architecture": "<name>"``,
``dense`` where it names none); the adapter is ``archs/<name>.py`` under
the benchmark's home, loaded by ``spec.load_cell``. It carries everything
that depends on the model's shape, so that a new architecture is files
alone: ``archs/<name>.py``, ``reference/<name>.py``, a configuration and
entries in ``BENCHMARK.json``. An adapter module defines:

- ``dims(config) -> Dims``: the widths a step runs at. The harness reads
  ``batch``, ``seq``, ``vocab`` and ``dtype`` (a ``torch`` dtype's name);
  the rest is the adapter's and its reference's.
- ``leaf_shapes(dims) -> {path: Leaf}``: every leaf of the train state's
  parameters, in the order ``make_weights`` draws them.
- ``build(dims, run, seed, device) -> (state, train_step, params_of)``:
  the program's train state (``state_dict()``, ``step``, an ``optimizer``
  whose ``state[tensor]["exp_avg"]`` is AdamW's first moment), its step
  ``train_step(state, tokens) -> (state, loss)``, and ``params_of(state)``,
  the live leaves by the paths of ``leaf_shapes``. ``run`` is the
  configuration's ``run`` block, ``seed`` the state's own RNG seed.
- ``reference``: the module name under ``reference/`` whose
  ``train_readings(weights, batches, dims, lr, betas, eps, weight_decay,
  compute="f32", keep_first_grads=False)`` follows the first steps
  (``compute="fp8"``: the control), reading trained leaves only.
- ``step_flops(dims)``, ``param_count(dims)``, ``leaf_count(dims)``,
  ``state_bytes(dims)``: model FLOPs of a step, parameters, tensors on the
  card and the state's bytes (what a save writes).
- ``kernels(dims) -> [Kernel]``: the roofline table of the kernels a step
  runs, read from a traced run's device operations.
- ``tiny(config) -> config``: the configuration cut to the CPU tests' size.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

DEFAULT = "dense"
REQUIRED = (
    "dims", "leaf_shapes", "build", "reference", "step_flops", "param_count", "leaf_count",
    "state_bytes", "kernels", "tiny",
)
INITS = ("ones", "zeros", "normal")


class Leaf(NamedTuple):
    """One leaf of the parameters: its shape, how it starts (``normal`` is
    N(0, 1/fan_in), fan_in ``shape[-2]``), whether the optimizer trains it
    (the training check compares trained leaves only), and its dtype where
    it is not the state's."""

    shape: Tuple[int, ...]
    init: str
    trained: bool = True
    dtype: Optional[str] = None


class Kernel(NamedTuple):
    """A roofline entry: the device operations whose time it sums (regular
    expressions searched in the profiler's names), the one whose launches
    count its calls, and the least time one call could take, in seconds."""

    name: str
    time: Tuple[str, ...]
    calls: str
    bound_s: float
