"""File formats of the port (paper §III-A.2d): :mod:`repro_torch.data.io`."""
