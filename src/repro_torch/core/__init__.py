"""SAMO core, PyTorch port: host layers (copied from ``repro.core``) plus
the device engine in ``core/accel``. Import the submodules directly, e.g.
``repro_torch.core.pipeline.optimise_mapping``."""
