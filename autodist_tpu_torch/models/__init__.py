"""Model zoo (so far the lm1b transformer) and its shared layers."""
