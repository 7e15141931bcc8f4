"""The default synthetic room (port of dsac_tpu/data/synthetic.py)."""
