"""Distribution substrate: int8 quantization shared by the KV tiers."""
