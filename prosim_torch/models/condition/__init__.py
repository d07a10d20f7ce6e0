"""Prompt conditions: encoders, the GNN condition attention, text attentions
and the condition transformer that dispatches over them."""
