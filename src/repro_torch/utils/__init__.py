"""Host-side helpers of the port (the roofline model of the card)."""
