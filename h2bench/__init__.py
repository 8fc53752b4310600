"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of H2Opus.

``python3 h2bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the CUDA card of
this machine.  Everything here but the cell runners in ``cells/`` is the
yardstick: the plain reference (``reference/``), the counts of work and
the peaks (``work/``), the reduction of a profiler trace (``trace.py``)
and the per-layer readers (``metrics/``).  None of it imports ``jax``,
the JAX package or anything of the port; only ``cells/`` calls the port.
"""
