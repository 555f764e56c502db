"""Flash attention forward: causal / sliding-window GQA over full sequences."""
