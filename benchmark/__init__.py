"""The benchmark of cfrk_tpu_torch on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix,
entry or metric lives in a file of its own, found by its name, so that
a later change adds one by adding files:

* ``configs/<config>.json``: the deployment's sizes, source, guarantees,
  ``reduced`` and ``assumed``;
* ``traffic/<traffic>.json``: the mix's parameters, among them the
  ``entry`` it calls, ``distinct_inputs`` and ``check_samples``;
* ``entries/<entry>.py``: ``PROGRAM_MODULE`` and ``PROGRAM_CALL`` (the
  program's call, looked up at each call), ``Workload(config, traffic,
  seed, device)`` with ``inputs``, ``call(input)``, ``bases_per_call``,
  ``reference(input)`` and ``mismatches(out, ref)``, and at module level
  ``reference(...)`` with the guarantees it can break and ``controls``;
* ``references/``: the plain references, which import nothing of the
  program;
* ``metrics/<metric>.py``: ``read(run)`` returns the metric, or None
  where the run has nothing to read.

``control.py`` gives the readings the check's limits were set from,
``sets.py`` the spread of sets of runs; ``python -m pytest benchmark/``
runs the tests (``-m card`` those that need the card).
"""
