"""Host control plane, plan layer and engine facade of the port."""
