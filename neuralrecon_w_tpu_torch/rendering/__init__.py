"""Volume rendering: NeuS-W sampling and compositing on tensors."""
