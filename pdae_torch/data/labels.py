"""The CelebA-HQ attribute table (the port's copy of
``pdae_tpu/data/datasets.py::CELEBAHQ.ID_TO_LABEL``): the 40 attributes in
the column order of ``CelebAMask-HQ-attribute-anno.txt``, which is the row
order of the manipulation classifier's weight."""

CELEBAHQ_ID_TO_LABEL = (
    "5_o_Clock_Shadow", "Arched_Eyebrows", "Attractive", "Bags_Under_Eyes",
    "Bald", "Bangs", "Big_Lips", "Big_Nose", "Black_Hair", "Blond_Hair",
    "Blurry", "Brown_Hair", "Bushy_Eyebrows", "Chubby", "Double_Chin",
    "Eyeglasses", "Goatee", "Gray_Hair", "Heavy_Makeup", "High_Cheekbones",
    "Male", "Mouth_Slightly_Open", "Mustache", "Narrow_Eyes", "No_Beard",
    "Oval_Face", "Pale_Skin", "Pointy_Nose", "Receding_Hairline",
    "Rosy_Cheeks", "Sideburns", "Smiling", "Straight_Hair", "Wavy_Hair",
    "Wearing_Earrings", "Wearing_Hat", "Wearing_Lipstick",
    "Wearing_Necklace", "Wearing_Necktie", "Young",
)
CELEBAHQ_LABEL_TO_ID = {label: i for i, label in enumerate(CELEBAHQ_ID_TO_LABEL)}
