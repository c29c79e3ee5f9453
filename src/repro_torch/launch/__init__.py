"""Launchers and tooling of the port: the command-line launchers
(``launch.serve``, ``launch.train``, ``launch.dryrun``,
``launch.roofline``), the production mesh and the card's peak rates
(``launch.mesh``), and storage-less input specs (``launch.specs``).

Not ported, having no torch form: XLA lowering and compilation, its
``memory_analysis`` and HLO ``collective_bytes``, the train step's
``grad_shardings`` and ``scan_layers``."""
