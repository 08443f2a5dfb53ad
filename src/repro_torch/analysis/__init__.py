"""Dry-run analysis of the port (port of repro/analysis/): the H100
roofline (roofline.py), the counts of a step traced on the meta device
(op_count.py, the counterpart of the reference's HLO parse) and the
tables of the dry run's JSON (render.py)."""
