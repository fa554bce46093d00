"""Configurations the port runs (so far: the paper's MRI case study)."""
