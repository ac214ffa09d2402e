"""Traffic: the frozen drill draw, the binary framing and the senders."""
