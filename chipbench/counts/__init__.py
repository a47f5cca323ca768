"""The yardstick's frozen counts: the work a call or a step defines, from
its shapes alone, and the card's published peaks."""
