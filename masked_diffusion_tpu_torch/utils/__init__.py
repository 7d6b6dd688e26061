"""Run directories, image grids and the metrics sink (host side)."""
