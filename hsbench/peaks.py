"""Published peaks by card name (NVIDIA's data sheets)."""

#: device-memory bandwidth, bytes/s
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # H100 SXM
    "NVIDIA H100 PCIe": 2.0e12,
}
