"""Tools that set the benchmark's fixed numbers; its runs do not use them."""
