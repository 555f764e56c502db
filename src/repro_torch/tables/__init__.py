"""Storage layer of the port.  So far only the byte-budgeted spill
manager, which the embedding store pages its vectors through; the
columnar tables come with the SQL layer."""
