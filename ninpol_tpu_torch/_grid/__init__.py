from .grid import Grid
