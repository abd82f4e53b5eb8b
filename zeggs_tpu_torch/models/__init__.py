"""Speech encoder, attention style encoder and the autoregressive decoder."""
