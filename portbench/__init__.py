"""The benchmark of the PyTorch and CUDA port, ``ddpm_ood_tpu_torch``.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell once on one CUDA card and prints one JSON line last. Every
cell is ``workloads/<cell>.json`` (its configuration, driver and traffic),
every configuration ``configs/<config>.json``, every kind of traffic a
driver ``drivers/<driver>.py`` and every metric a reader
``metrics/<metric>.py``, all found by name. ``reference/`` is the plain
PyTorch reference that decides ``correct``; it imports nothing of the
port. ``python3 -m portbench.readings`` takes the readings the limits of
``correct`` are set from.
"""
