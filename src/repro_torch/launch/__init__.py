"""Launch-side helpers of the port: backend resolution, and the LM path
profiler (``lm_step_profile.py``, run on a CUDA card)."""
