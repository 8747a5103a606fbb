"""The AMB-DG core of the port: anytime accumulation, the delay ring on
the gradient arena, dual averaging, and the strategies composing them."""
