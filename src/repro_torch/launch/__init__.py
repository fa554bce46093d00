"""Launch-side helpers of the port: device meshes and per-lane profiles
(``mesh.py``), backend resolution, and the LM path profiler
(``lm_step_profile.py``, run on a CUDA card)."""
