"""Launch layer (port of ``repro.launch``): the learner mesh
(``launch.mesh``), the serving launch surface (``launch.serve``), the
LM protocol trainer (``launch.train``) and the assigned input shapes
with the long-context policy (``launch.specs``).

As in the reference this package imports nothing eagerly: import
``repro_torch.launch.mesh``, ``.serve``, ``.train`` or ``.specs``.
"""
