"""Storage layer of the port: the columnar `Table` (``table.py``), the
chunked table whose chunks a byte-budgeted spill manager pages out and
back (``chunked.py``, ``spill.py``), as in the JAX package.  The embedding
store pages its vectors through the same spill manager."""
