"""Speech encoder, style encoders (attn, gru) and the autoregressive decoder."""
