"""Launch-side helpers of the port (backend resolution)."""
