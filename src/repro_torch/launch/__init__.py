"""Command-line entry points of the port: ``python -m
repro_torch.launch.train`` and ``python -m repro_torch.launch.serve``
(the twins of ``repro/launch/train.py`` and ``serve.py``), and the mesh
parsing they share (``launch.mesh``)."""
