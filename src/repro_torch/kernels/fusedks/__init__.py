from .ops import key_switch_digits, mod_down_digits
