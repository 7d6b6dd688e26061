"""Datasets and the data-mean histogram (host side, numpy)."""
