"""The benchmark of the PyTorch + CUDA port (``repro_torch``) on one card.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Everything a
cell needs is found by name: ``configs/<config>.json``,
``traffic/<traffic>.json`` (whose ``entry`` names a driver in
``entries/`` and whose ``call``, where it has one, a compiled function in
``calls/``), ``limits/<cell>.json``, ``flops/<subject>.py`` and
``reference/<subject>.py`` (the subject: the ``call``, else the
configuration), and ``metrics/<metric>.py`` or ``metrics/<quantity>.py``
for a per-layer metric ``<quantity>.<kind>``.  Nothing here imports JAX
or the JAX package; the references import nothing of the port either.
"""
