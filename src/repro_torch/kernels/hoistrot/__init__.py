from .ops import galois_mac, mod_up_digits
