"""The benchmark of the PyTorch and CUDA port (``repro_torch``): PRF training and bulk scoring.

``run.py`` is the command; ``harness.py`` finds a cell's files by name;
``kinds/`` holds the traffic generators, ``traffic/``, ``configs/`` and
``workloads/`` their data, ``metrics/`` the per-layer readers,
``reference.py`` the plain reference that decides ``correct`` and
``work.py`` the work counts of the rooflines.
"""
