"""Host-side data: records, bucketing, synthetic layouts (numpy only)."""
