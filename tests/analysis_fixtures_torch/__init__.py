"""Seeded-defect fixtures for the port's dttlint (``tests/test_torch_analysis.py``).

The torch twins of ``tests/analysis_fixtures``' JAX fixtures: each
``*_bad`` module plants the hazards its rules must catch, at the lines
marked ``# SEED: <rule-id>``, in the port's idioms (a captured CUDA
graph's replay, a graph family's static buffers, the engine's
``fetch_async``); each ``*_clean`` module is the same shape with the
hazards fixed and must produce ZERO findings.  They are read as source
and never imported, and lie outside the analyzer's default targets.
"""
