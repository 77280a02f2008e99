"""Input pipeline of the PyTorch port (see ``data/pipeline.py``)."""
