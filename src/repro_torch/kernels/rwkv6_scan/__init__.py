"""RWKV-6 wkv recurrence with an [hd, hd] fp32 state per (row, head)."""
