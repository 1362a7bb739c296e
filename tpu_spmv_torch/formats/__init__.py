"""Device layouts of the port as torch containers (see sell.py, dia.py)."""
