"""GRU-family model pieces used by the CLaSS round."""
