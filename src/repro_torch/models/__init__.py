"""Dense decoder: layers, ring-cache attention, the LM and the weight converter."""
