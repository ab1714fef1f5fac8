"""Launch layer (port of ``repro.launch``): the learner mesh
(``launch.mesh``) and the serving launch surface (``launch.serve``).

As in the reference this package imports nothing eagerly: import
``repro_torch.launch.mesh`` or ``repro_torch.launch.serve``.
"""
